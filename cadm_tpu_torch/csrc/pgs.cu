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
// What bounds it on the card: that chain of dependent dot products, shuffle
// reductions and divides, not bytes (A is read once, 9 KB per env at
// cheetah). The design shortens the chain and keeps many envs in flight:
//
// - Active-set compaction (exact). A contact with μ = 0 writes λ = 0 on
//   every update and, once its λ is 0, adds nothing to any other row's dot.
//   Each env's group of lanes ballots its active contacts, loads only their
//   3na × 3na sub-block of A (and their slices of b, v*, μ, λ0) into shared
//   memory and sweeps na contacts over rows of 3na. Where some inactive
//   contact has a nonzero λ0, the group loads the full problem, runs the
//   first sweep over all contacts (which zeroes every inactive λ) and then
//   compacts A, λ and b in place to the active set for the later sweeps. An
//   env with na = 0 writes zeros and stops. Inactive contacts are written
//   as λ = 0.
// - Short reductions. A group of G lanes (16 for rows of ≤ 96 columns, else
//   32) serves one env, so a row dot ends in log2(G) shuffle levels and two
//   envs share a warp. (8 lanes measured slower at cheetah: the longer
//   per-lane loops over the row cost more than the shuffle level saved.) A contact's three row dots are taken in one
//   pass over λ and reduced together, the tangent ones corrected for the
//   new λn afterwards, so a contact costs one reduction and one __syncwarp;
//   the diagonal is inverted once per solve. The ragged env edge is masked
//   per group, with no identity padding.
// - Occupancy. Blocks are 64 threads. Each block carves its envs' regions
//   out of one shared-memory pool by an atomic bump; an env whose region
//   does not fit waits for the next round of its block. The launch sizes the
//   pool so that every block the launch needs per SM is resident: the whole
//   worst case (every contact active) where that fits, as at 2048 envs,
//   else down to one env's worst case, so the SM then holds as many envs as
//   their active sets allow. Above 48 KB the pool is opt-in dynamic shared
//   memory. Rows are stored at an odd stride against bank conflicts. A is
//   read from device memory once per solve, row by row, each lane looking
//   up its columns' sources once.
#include <cuda_runtime.h>

#include "launch_once.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kReservedPerBlock = 1024;  // shared memory the system keeps per block
constexpr int kHeaderInts = 5;  // per group and contact: list, pos, 3 columns

// floats of one env's region with nl contacts loaded: A (m × m at an odd
// stride), then λ, b (m each), v*, μ (nl each), 1/diag(A) (m), m = 3·nl
__host__ __device__ __forceinline__ int region_floats(int nl) {
  const int m = 3 * nl;
  return m * (m | 1) + 3 * m + 2 * nl;
}

// index of compacted row/column i in the loaded problem
__device__ __forceinline__ int src_index(const int* list, int i) {
  return 3 * list[i / 3] + i % 3;
}

// A contact's three row dots (x, y, z rows) in one pass over λ, the three
// partial sums reduced together; every lane of the group gets the sums.
template <int G>
__device__ __forceinline__ void group_dot3(const float* rx, const float* ry,
                                           const float* rz, const float* lam,
                                           int m, int lane, unsigned gmask,
                                           float& sx, float& sy, float& sz) {
  sx = sy = sz = 0.f;
#pragma unroll 2
  for (int k = lane; k < m; k += G) {
    const float l = lam[k];
    sx += rx[k] * l;
    sy += ry[k] * l;
    sz += rz[k] * l;
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    sx += __shfl_xor_sync(gmask, sx, off, G);
    sy += __shfl_xor_sync(gmask, sy, off, G);
    sz += __shfl_xor_sync(gmask, sz, off, G);
  }
}

template <int G>
__device__ __forceinline__ void invert_diag(const float* sA, int S, float* inv,
                                            int m, int lane, unsigned gmask) {
  for (int i = lane; i < m; i += G) inv[i] = 1.f / sA[i * S + i];
  __syncwarp(gmask);
}

// Move the active sub-block of A (loaded in full, stride S) to the front
// in place, keeping the stride. Every element moves to an address no larger
// than its own, in increasing order, so a chunk of G elements is read before
// any of it is written and never overwrites an element still to be read.
template <int G>
__device__ void compact_A(float* sA, int S, const int* list, int na, int lane,
                          unsigned gmask) {
  const int m = 3 * na, total = m * m;
  for (int p0 = 0; p0 < total; p0 += G) {
    const int p = p0 + lane;
    float v = 0.f;
    int dst = -1;
    if (p < total) {
      const int i = p / m, j = p - i * m;
      v = sA[src_index(list, i) * S + src_index(list, j)];
      dst = i * S + j;
    }
    __syncwarp(gmask);
    if (dst >= 0) sA[dst] = v;
    __syncwarp(gmask);
  }
}

// the same for a vector of 3 entries per contact (stride 3) or one (stride 1)
template <int G>
__device__ void compact_vec(float* x, int per, const int* list, int na,
                            int lane, unsigned gmask) {
  const int total = per * na;
  for (int p0 = 0; p0 < total; p0 += G) {
    const int p = p0 + lane;
    float v = 0.f;
    if (p < total) v = x[per * list[p / per] + p % per];
    __syncwarp(gmask);
    if (p < total) x[p] = v;
    __syncwarp(gmask);
  }
}

// One env's solve by its group, in its region R of the pool.
template <int G>
__device__ void solve_env(const float* __restrict__ A,
                          const float* __restrict__ b,
                          const float* __restrict__ vstar,
                          const float* __restrict__ actmu,
                          const float* __restrict__ lam0,
                          float* __restrict__ lam_out, long long env, int nc,
                          int iters, const int* list, const int* pos,
                          int* col, int na, bool full, float* R, int lane,
                          unsigned gmask) {
  const int n = 3 * nc;
  int nl = full ? nc : na;  // contacts loaded
  int m = 3 * nl;
  const int S = m | 1;
  float* sA = R;
  float* lam = sA + m * S;
  float* sb = lam + m;
  float* vs = sb + m;
  float* mu = vs + nl;
  float* inv = mu + nl;

  // ---- gather A's sub-block row by row: lane j of the group takes the
  // columns j, j + G, ... of each row, whose sources it looked up once;
  // 16 loads in flight per lane, no divisions
  for (int j = lane; j < m; j += G) col[j] = full ? j : src_index(list, j);
  __syncwarp(gmask);
  const float* gA = A + env * n * n;
  const int T = (m + G - 1) / G, total = m * T;
  int i = 0, t = 0;
  const float* grow = gA + (size_t)(full ? 0 : src_index(list, 0)) * n;
  for (int q0 = 0; q0 < total; q0 += 16) {
    float v[16];
    int dst[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int j = lane + t * G;
      dst[u] = -1;
      if (q0 + u < total && j < m) {
        v[u] = grow[col[j]];
        dst[u] = i * S + j;
      }
      if (++t == T) {
        t = 0;
        if (++i < m) grow = gA + (size_t)(full ? i : src_index(list, i)) * n;
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (dst[u] >= 0) sA[dst[u]] = v[u];
  }
  // λ0 and b (m each), then v* and μ (nl each)
  for (int k0 = lane; k0 < 2 * m + 2 * nl; k0 += 4 * G) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int k = k0 + u * G;
      if (k < m) {
        v[u] = lam0[env * n + col[k]];
      } else if ((k -= m) < m) {
        v[u] = b[env * n + col[k]];
      } else if ((k -= m) < nl) {
        v[u] = vstar[env * nc + (full ? k : list[k])];
      } else if ((k -= nl) < nl) {
        v[u] = actmu[env * nc + (full ? k : list[k])];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k0 + u * G < 2 * m + 2 * nl) lam[k0 + u * G] = v[u];
  }
  __syncwarp(gmask);
  invert_diag<G>(sA, S, inv, m, lane, gmask);

  // ---- sweeps. Per contact one pass over its three rows: the tangent dots
  // are taken with the λn from before the update and corrected by
  // A[x|y, z]·(λn_new − λn_old), which equals the reference's order of
  // normal row first, then tangent rows against the updated λn; lane 0
  // writes the contact's three λ and one __syncwarp publishes them.
  for (int it = 0; it < iters; ++it) {
    if (full && it == 1) {
      // every inactive λ is 0 now: continue over the active set only
      compact_A<G>(sA, S, list, na, lane, gmask);
      compact_vec<G>(lam, 3, list, na, lane, gmask);
      compact_vec<G>(sb, 3, list, na, lane, gmask);
      compact_vec<G>(vs, 1, list, na, lane, gmask);
      compact_vec<G>(mu, 1, list, na, lane, gmask);
      full = false;
      nl = na;
      m = 3 * na;
      if (na == 0) break;
      invert_diag<G>(sA, S, inv, m, lane, gmask);
    }
    for (int k = 0; k < nl; ++k) {
      const int ix = 3 * k, iy = 3 * k + 1, iz = 3 * k + 2;
      const float* rx = sA + ix * S;
      const float* ry = sA + iy * S;
      float sx, sy, sz;
      group_dot3<G>(rx, ry, sA + iz * S, lam, m, lane, gmask, sx, sy, sz);
      const float lz0 = lam[iz];
      const float active = mu[k] > 0.f ? 1.f : 0.f;
      const float ln =
          fmaxf(lz0 - (sz + sb[iz] - vs[k]) * inv[iz], 0.f) * active;
      const float dn = ln - lz0;
      const float lx = lam[ix] - (sx + rx[iz] * dn + sb[ix]) * inv[ix];
      const float ly = lam[iy] - (sy + ry[iz] * dn + sb[iy]) * inv[iy];
      const float t_norm = sqrtf(lx * lx + ly * ly) + 1e-9f;
      const float scale = fminf(1.f, __fdividef(mu[k] * ln, t_norm));
      if (lane == 0) {
        lam[iz] = ln;
        lam[ix] = lx * scale;
        lam[iy] = ly * scale;
      }
      __syncwarp(gmask);
    }
  }

  // ---- write λ, coalesced: zeros for the contacts not in the final set
  float* out = lam_out + env * n;
  for (int t = lane; t < n; t += G) {
    const int c = t / 3, p = full ? c : pos[c];
    out[t] = p >= 0 ? lam[3 * p + t - 3 * c] : 0.f;
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
pgs_kernel(const float* __restrict__ A, const float* __restrict__ b,
           const float* __restrict__ vstar, const float* __restrict__ actmu,
           const float* __restrict__ lam0, float* __restrict__ lam_out,
           int E, int nc, int iters, int pool_floats) {
  extern __shared__ float smem[];
  __shared__ int used;
  constexpr int kGroups = kThreads / G;
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const int gbase = (threadIdx.x % 32) & ~(G - 1);
  const unsigned low = G == 32 ? 0xffffffffu : ((1u << G) - 1u);
  const unsigned gmask = low << gbase;
  const int n = 3 * nc;
  const long long env = (long long)blockIdx.x * kGroups + grp;
  const bool valid = env < E;
  // per group: the active contacts in order, each contact's index in that
  // list (or -1), and the source column of each loaded row/column
  int* list = reinterpret_cast<int*>(smem) + kHeaderInts * grp * nc;
  int* pos = list + nc;
  int* col = pos + nc;
  float* pool = smem + kHeaderInts * kGroups * nc;

  // ---- the env's active contacts, in order; is any inactive λ0 nonzero?
  int na = 0;
  bool dirty = false;
  for (int c0 = 0; c0 < nc; c0 += G) {
    const int c = c0 + lane;
    bool act = false, nz = false;
    if (valid && c < nc) {
      act = actmu[env * nc + c] > 0.f;
      if (!act) {
        const float* l = lam0 + env * n + 3 * c;
        nz = l[0] != 0.f || l[1] != 0.f || l[2] != 0.f;
      }
    }
    const unsigned bal = (__ballot_sync(gmask, act) >> gbase) & low;
    const int at = na + __popc(bal & ((1u << lane) - 1u));
    if (act) list[at] = c;
    if (c < nc) pos[c] = act ? at : -1;
    na += __popc(bal);
    dirty |= __any_sync(gmask, nz) != 0;
  }
  __syncwarp(gmask);

  bool pending = false;
  int need = 0;
  if (valid) {
    if (na == 0 && !dirty) {
      for (int t = lane; t < n; t += G) lam_out[env * n + t] = 0.f;
    } else {
      pending = true;
      need = region_floats(dirty ? nc : na);
    }
  }
  // ---- rounds: the groups whose regions fit in the pool solve, the rest
  // wait; the first reservation of a round always fits (the launch sizes
  // the pool for one env's worst case at least)
  while (__syncthreads_or(pending)) {
    if (threadIdx.x == 0) used = 0;
    __syncthreads();
    int off = 0;
    if (pending && lane == 0) off = atomicAdd(&used, need);
    off = __shfl_sync(gmask, off, 0, G);
    if (pending && off + need <= pool_floats) {
      solve_env<G>(A, b, vstar, actmu, lam0, lam_out, env, nc, iters, list,
                   pos, col, na, dirty, pool + off, lane, gmask);
      pending = false;
    }
  }
}

template <int G>
int launch(const float* A, const float* b, const float* vstar,
           const float* actmu, const float* lam0, float* lam_out, int E,
           int nc, int iters, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  static bool opted[cadm::kMaxDevices];  // this instantiation's opt-in
  cadm::DeviceAttrs attrs{};
  cudaError_t e = cadm::device_attrs(&attrs);
  if (e == cudaSuccess)
    e = cadm::opt_in_smem(reinterpret_cast<const void*>(&pgs_kernel<G>),
                          opted);
  if (e != cudaSuccess) return (int)e;
  const int sms = attrs.sms, smem_sm = attrs.smem_sm,
            smem_block = attrs.smem_block;

  const int blocks = (E + kGroups - 1) / kGroups;
  const int header = kHeaderInts * kGroups * nc * (int)sizeof(int);
  const int fixed = header + (int)sizeof(int);  // + the static `used`
  const int worst = region_floats(nc);
  // every block the launch needs per SM resident, if the pool can shrink
  // that far; never below one env's worst case, never above all of them
  const int per_sm = (blocks + sms - 1) / sms;
  const int budget = smem_sm / per_sm - kReservedPerBlock - fixed;
  int pool = budget / (int)sizeof(float);
  if (pool > kGroups * worst) pool = kGroups * worst;
  if (pool < worst) pool = worst;
  if (fixed + pool * (int)sizeof(float) > smem_block) {
    pool = (smem_block - fixed) / (int)sizeof(float);
    if (pool < worst) return (int)cudaErrorInvalidValue;  // nc too large
  }
  const size_t smem = (size_t)header + (size_t)pool * sizeof(float);
  pgs_kernel<G><<<blocks, kThreads, smem, stream>>>(
      A, b, vstar, actmu, lam0, lam_out, E, nc, iters, pool);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cadm_pgs(const float* A, const float* b, const float* vstar,
                        const float* actmu, const float* lam0, float* lam_out,
                        int E, int nc, int iters, void* stream) {
  if (E <= 0 || nc <= 0) return 0;
  const int n = 3 * nc;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 96) return launch<16>(A, b, vstar, actmu, lam0, lam_out, E, nc, iters, s);
  return launch<32>(A, b, vstar, actmu, lam0, lam_out, E, nc, iters, s);
}

extern "C" const char* cadm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
