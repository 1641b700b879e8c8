// Layer sweep of the SOS solver (both hemispheres), hand-written for Hopper
// (sm_90a), float and double.
//
// Replaces: pallas_ops.py of the JAX package, sweep_scan_batched /
// _sweep_kernel / _scan_fwd / _scan_rev (reference SOS_INTEGR_EPOPT,
// src/SOS_OS.F:2222-2354).
//
// What it computes.  For every instance b = (order s, term t) and every
// direction lane c of a hemisphere, the source linear in optical depth is
// integrated through the layers as a first-order affine recurrence:
//
//   down, from TOA:     f[0] = 0,
//                       f[l] = a f[l-1] + (1-a)(-al mu + sd[l]) + al a dt,
//                       dt = h[l]-h[l-1], al = (sd[l]-sd[l-1]) / dt
//   up, from the ground: f[NT] = bc,
//                       f[l] = a f[l+1] + (1-a)(al mu + su[l]) - al a dt,
//                       dt = h[l+1]-h[l], al = (su[l+1]-su[l]) / dt
//
// with a = exp(-dt / mu).  A layer with dt = 0 (zero-thickness padding) has
// a = 1 and 1/dt stored as 0, so it is an identity step.  The per-level
// (dt_dn, 1/dt_dn, dt_up, 1/dt_up) come from ops.sweep_coeffs, one row per
// term: (T, L, 4).
//
// What bounds it on this card.  Every field and source element is read once
// and written once with a handful of flops and one exp each: at the demo
// shape about 1.5 GB per call in float32, a few flops per byte, so the
// kernel is bound by device-memory bandwidth (3.35 TB/s).
//
// What the design does about it.  The TPU kernel's chunked Hillis-Steele
// scan with VMEM carries across sequential grid steps exists because of the
// TPU's layout; on Hopper blocks run in no order, so nothing may carry
// between them.  Here one thread owns one (instance, lane, hemisphere) and
// walks all levels itself, keeping the carry in a register: there is no
// cross-thread state at all.  Neighbouring threads own neighbouring lanes of
// one instance, so every level's load and store is coalesced across the
// warp.  The loads do not depend on the carry, so the unrolled loop keeps
// several levels' loads in flight.  exp / expf are the accurate library
// functions, not __expf.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

template <typename T>
__global__ void __launch_bounds__(128)
sweep_kernel(const T* __restrict__ src_up, const T* __restrict__ src_dn,
             const T* __restrict__ coeffs, const T* __restrict__ mu,
             const T* __restrict__ bc, T* __restrict__ up, T* __restrict__ dn,
             long long n_inst, long long n_terms, int levels, int hp) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_inst * hp) return;
  const long long b = idx / hp;
  const int c = (int)(idx - b * hp);
  const T* cf = coeffs + (b % n_terms) * (long long)levels * 4;
  const T m = mu[c];
  const long long base = b * (long long)levels * hp + c;

  if (blockIdx.y == 0) {
    // down: TOA (f = 0) -> ground
    T f = T(0);
    T lo = src_dn[base];
    dn[base] = f;
#pragma unroll 4
    for (int l = 1; l < levels; ++l) {
      const long long o = base + (long long)l * hp;
      const T hi = src_dn[o];
      const T dt = cf[4 * l];
      const T rd = cf[4 * l + 1];
      const T a = exp_t(-dt / m);
      const T al = (hi - lo) * rd;
      const T bb = (T(1) - a) * (-al * m + hi) + al * a * dt;
      f = a * f + bb;
      dn[o] = f;
      lo = hi;
    }
  } else {
    // up: ground boundary (f = bc) -> TOA
    const int nt = levels - 1;
    T f = bc[idx];
    T hi = src_up[base + (long long)nt * hp];
    up[base + (long long)nt * hp] = f;
#pragma unroll 4
    for (int l = nt - 1; l >= 0; --l) {
      const long long o = base + (long long)l * hp;
      const T lo = src_up[o];
      const T dt = cf[4 * l + 2];
      const T rd = cf[4 * l + 3];
      const T a = exp_t(-dt / m);
      const T al = (hi - lo) * rd;
      const T bb = (T(1) - a) * (al * m + lo) - al * a * dt;
      f = a * f + bb;
      up[o] = f;
      hi = lo;
    }
  }
}

template <typename T>
int launch(const T* src_up, const T* src_dn, const T* coeffs, const T* mu,
           const T* bc, T* up, T* dn, long long n_inst, long long n_terms,
           long long levels, long long hp, void* stream) {
  if (n_inst <= 0 || levels <= 0 || hp <= 0) return 0;
  const int threads = 128;
  const long long work = n_inst * hp;
  const dim3 grid((unsigned)((work + threads - 1) / threads), 2);
  sweep_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      src_up, src_dn, coeffs, mu, bc, up, dn, n_inst, n_terms, (int)levels,
      (int)hp);
  return (int)cudaGetLastError();
}

}  // namespace

// Fields (n_inst, levels, hp) with instance b = s * n_terms + t; coeffs
// (n_terms, levels, 4); mu (hp,); bc (n_inst, hp).  Every array contiguous.
extern "C" int sos_sweep_f32(const float* src_up, const float* src_dn,
                             const float* coeffs, const float* mu,
                             const float* bc, float* up, float* dn,
                             long long n_inst, long long n_terms,
                             long long levels, long long hp, void* stream) {
  return launch<float>(src_up, src_dn, coeffs, mu, bc, up, dn, n_inst,
                       n_terms, levels, hp, stream);
}

extern "C" int sos_sweep_f64(const double* src_up, const double* src_dn,
                             const double* coeffs, const double* mu,
                             const double* bc, double* up, double* dn,
                             long long n_inst, long long n_terms,
                             long long levels, long long hp, void* stream) {
  return launch<double>(src_up, src_dn, coeffs, mu, bc, up, dn, n_inst,
                        n_terms, levels, hp, stream);
}
