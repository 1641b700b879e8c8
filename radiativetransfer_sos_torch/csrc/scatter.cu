// Order-IG scattering source of the SOS solver, hand-written for Hopper
// (sm_90a), float and double.
//
// Replaces: pallas_ops.py of the JAX package, scatter_fused /
// _scatter_kernel (reference SOS_FSOURCE_ORDREIG, src/SOS_OS.F:2663).
//
// What it computes.  For each Fourier order s and each row r = (term t,
// level l) of that order's field:
//
//     src[s, r, :] = [x u, x d, y u, y d][s, r, :] @ M[s]
//
// u, d: the previous scattering order's field hemispheres, (S, T, L, HP)
// each, HP = 3N lanes (Stokes-major, no lane padding); x, y: the per-level
// aerosol / molecular scattering fractions, (T, L), shared by all orders;
// M[s]: the order's flat operator, (4 HP, 2 HP), Gauss weights and the 1/2
// of the source integral folded in (solver._flat_operator).  Product
// columns [0, HP) are the upward source, [HP, 2 HP) the downward one; they
// are written as two separate (S, T, L, HP) arrays, the layout the sweep
// kernel reads.
//
// What bounds it on this card.  At the demo shape (S*T = 1296 instances,
// L = 601, 3N = 123) one call is about 188 GFLOP against about 1.5 GB of
// device-memory traffic (field in, source out, operators), some 125
// FLOP/byte.  That is far above the H100's FP32 ridge (67 TFLOP/s over
// 3.35 TB/s, about 20 FLOP/byte), so on Hopper this kernel is
// compute-bound, unlike the bandwidth-bound account of the TPU kernel.
//
// What the design does about it.  A shared-memory tiled GEMM with register
// blocking, one thread block per (column tile, row tile, order): blocks are
// independent, nothing carries between them.  Each thread accumulates a
// TM x TN register tile in the working type (no TF32, no tensor cores:
// wgmma / 3xTF32 / DMMA are later work), so every value loaded from shared
// memory feeds TM or TN FMAs.  The x/y mix is applied while the A tile is
// staged into shared memory, so the 4 HP-wide mixed operand never exists in
// device memory and x, y are read once per row tile.  Ragged edges (rows
// past T*L, columns past 2 HP, the K tail) are zero-filled in shared memory.

#include <cuda_runtime.h>

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
scatter_kernel(const T* __restrict__ up, const T* __restrict__ dn,
               const T* __restrict__ x, const T* __restrict__ y,
               const T* __restrict__ m, T* __restrict__ out_up,
               T* __restrict__ out_dn, long long rows, int hp) {
  constexpr int RS = BM / TM;          // thread rows
  constexpr int CS = BN / TN;          // thread columns
  constexpr int NTH = RS * CS;
  __shared__ T as[BK][BM + 4];         // A tile, k-major; +4 breaks bank aliasing
  __shared__ T bs[BK][BN];
  __shared__ T xs[BM];
  __shared__ T ys[BM];

  const int tid = threadIdx.x;
  const int tx = tid % CS;
  const int ty = tid / CS;
  const int s = blockIdx.z;
  const long long row0 = (long long)blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int kdim = 4 * hp;
  const int ncol = 2 * hp;
  const long long field = (long long)s * rows * hp;
  const T* up_s = up + field;
  const T* dn_s = dn + field;
  const T* m_s = m + (long long)s * kdim * ncol;

  for (int i = tid; i < BM; i += NTH) {
    const long long r = row0 + i;
    xs[i] = r < rows ? x[r] : T(0);
    ys[i] = r < rows ? y[r] : T(0);
  }

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < kdim; k0 += BK) {
    __syncthreads();  // xs/ys ready; previous tile consumed
    for (int e = tid; e < BM * BK; e += NTH) {
      const int r = e / BK;
      const int kk = e - r * BK;
      const int k = k0 + kk;
      const long long row = row0 + r;
      T v = T(0);
      if (row < rows && k < kdim) {
        const int q = k / hp;            // 0: x u, 1: x d, 2: y u, 3: y d
        const int c = k - q * hp;
        const T* f = (q & 1) ? dn_s : up_s;
        v = f[row * hp + c] * (q < 2 ? xs[r] : ys[r]);
      }
      as[kk][r] = v;
    }
    for (int e = tid; e < BK * BN; e += NTH) {
      const int kk = e / BN;
      const int j = e - kk * BN;
      const int k = k0 + kk;
      const int col = col0 + j;
      bs[kk][j] = (k < kdim && col < ncol) ? m_s[(long long)k * ncol + col]
                                           : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk][ty + i * RS];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[kk][tx + j * CS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];  // fused by nvcc
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = row0 + ty + i * RS;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * CS;
      if (col < hp) {
        out_up[field + row * hp + col] = acc[i][j];
      } else if (col < ncol) {
        out_dn[field + row * hp + (col - hp)] = acc[i][j];
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const T* up, const T* dn, const T* x, const T* y, const T* m,
           T* out_up, T* out_dn, long long n_s, long long rows, long long hp,
           void* stream) {
  if (n_s <= 0 || rows <= 0 || hp <= 0) return 0;
  const dim3 grid((unsigned)((2 * hp + BN - 1) / BN),
                  (unsigned)((rows + BM - 1) / BM), (unsigned)n_s);
  const dim3 block((BM / TM) * (BN / TN));
  scatter_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          up, dn, x, y, m, out_up, out_dn, rows, (int)hp);
  return (int)cudaGetLastError();
}

}  // namespace

// rows = T * L (term-major, then level); every array contiguous.
extern "C" int sos_scatter_f32(const float* up, const float* dn,
                               const float* x, const float* y, const float* m,
                               float* out_up, float* out_dn, long long n_s,
                               long long rows, long long hp, void* stream) {
  return launch<float, 128, 128, 8, 8, 8>(up, dn, x, y, m, out_up, out_dn,
                                          n_s, rows, hp, stream);
}

extern "C" int sos_scatter_f64(const double* up, const double* dn,
                               const double* x, const double* y,
                               const double* m, double* out_up,
                               double* out_dn, long long n_s, long long rows,
                               long long hp, void* stream) {
  return launch<double, 64, 64, 8, 4, 4>(up, dn, x, y, m, out_up, out_dn,
                                         n_s, rows, hp, stream);
}
