// Batched projected Gauss–Seidel contact solve (kernel K1).
//
// Replaces the Pallas TPU kernel cadm_tpu/ops/pgs.py::_pgs_kernel (wrapper
// pgs_solve). Computes what that kernel computes: `iters` sweeps over the
// contacts in order; per contact the normal row
//   λn = max(λn − (A[z]·λ + b[z] − v*)/A[z,z], 0) · active
// then the two tangent rows, scaled into the friction cone μ·λn. Each row
// reads the λ already updated within the sweep, so a sweep is a strictly
// sequential chain of scalar updates; only the env axis is parallel.
//
// Design: one warp per env. The env's Delassus block A (3nc × 3nc) and λ sit
// in shared memory for all sweeps, so device memory is read once (A, b, v*,
// μ, λ0) and written once (λ). A row update is a warp-wide dot product
// (lanes stride the row, then a butterfly shuffle sum leaves the result in
// every lane); lane 0 writes the new λ entries and __syncwarp() publishes
// them. What bounds it on the card: the serial chain of 3·nc dependent
// shuffle reductions per sweep (latency), not bytes; cheetah's A is 9 KB per
// env and humanoid's 30 KB, so up to four envs share a block below the 48 KB
// default shared-memory limit. The ragged edge of the env axis is masked (a
// warp past E exits), with no identity-block padding.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarpsPerBlock = 4;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float row_dot(const float* row, const float* lam,
                                         int n, int lane) {
  float s = 0.f;
  for (int k = lane; k < n; k += kWarp) s += row[k] * lam[k];
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__global__ void pgs_kernel(const float* __restrict__ A,
                           const float* __restrict__ b,
                           const float* __restrict__ vstar,
                           const float* __restrict__ actmu,
                           const float* __restrict__ lam0,
                           float* __restrict__ lam_out, int E, int nc,
                           int iters, int warps_per_block) {
  extern __shared__ float smem[];
  const int n = 3 * nc;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long env = (long long)blockIdx.x * warps_per_block + warp;
  // ragged edge: the whole warp leaves; only warp-level syncs follow
  if (env >= E) return;

  float* sA = smem + (size_t)warp * (n * n + n);
  float* lam = sA + n * n;
  const float* gA = A + env * n * n;
  for (int k = lane; k < n * n; k += kWarp) sA[k] = gA[k];
  for (int k = lane; k < n; k += kWarp) lam[k] = lam0[env * n + k];
  __syncwarp();

  const float* gb = b + env * n;
  const float* gv = vstar + env * nc;
  const float* gm = actmu + env * nc;
  for (int it = 0; it < iters; ++it) {
    for (int i = 0; i < nc; ++i) {
      const int iz = 3 * i + 2, ix = 3 * i, iy = 3 * i + 1;
      const float mu = gm[i];
      const float active = mu > 0.f ? 1.f : 0.f;
      const float r = row_dot(sA + iz * n, lam, n, lane) + gb[iz] - gv[i];
      const float ln = fmaxf(lam[iz] - r / sA[iz * n + iz], 0.f) * active;
      __syncwarp();
      if (lane == 0) lam[iz] = ln;
      __syncwarp();
      const float rx = row_dot(sA + ix * n, lam, n, lane) + gb[ix];
      const float ry = row_dot(sA + iy * n, lam, n, lane) + gb[iy];
      const float lx = lam[ix] - rx / sA[ix * n + ix];
      const float ly = lam[iy] - ry / sA[iy * n + iy];
      const float t_norm = sqrtf(lx * lx + ly * ly) + 1e-9f;
      const float scale = fminf(1.f, mu * ln / t_norm);
      __syncwarp();
      if (lane == 0) {
        lam[ix] = lx * scale;
        lam[iy] = ly * scale;
      }
      __syncwarp();
    }
  }
  for (int k = lane; k < n; k += kWarp) lam_out[env * n + k] = lam[k];
}

}  // namespace

extern "C" int cadm_pgs(const float* A, const float* b, const float* vstar,
                        const float* actmu, const float* lam0, float* lam_out,
                        int E, int nc, int iters, void* stream) {
  if (E <= 0 || nc <= 0) return 0;
  const int n = 3 * nc;
  const size_t per_env = (size_t)(n * n + n) * sizeof(float);
  int warps = (int)(kDefaultSmem / per_env);
  warps = warps < 1 ? 1 : (warps > kMaxWarpsPerBlock ? kMaxWarpsPerBlock : warps);
  const size_t smem = warps * per_env;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        pgs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (int)((E + warps - 1) / warps);
  pgs_kernel<<<blocks, warps * kWarp, smem, (cudaStream_t)stream>>>(
      A, b, vstar, actmu, lam0, lam_out, E, nc, iters, warps);
  return (int)cudaGetLastError();
}

extern "C" const char* cadm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
