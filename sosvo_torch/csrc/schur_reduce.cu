// Schur reduction of windowed bundle adjustment onto the camera system.
//
// Replaces the Pallas TPU kernel `sosvo/kernels/schur_pallas.py:
// schur_reduce_pallas` (body `_schur_kernel`, wrapper
// `reduce_camera_system_pallas`) and computes what it computes: for every
// landmark l of a window of W keyframes and L landmark slots,
//     H_ll_inv[l] = (H_ll[l] + lam I)^-1          (closed-form 3x3 adjugate)
//     A[w, l]     = H_cl[w, l] H_ll_inv[l]        (6 x 3 per keyframe)
//     S_off       = sum_l A[:, l] H_cl[:, l]^T    ((6W) x (6W))
//     b_sub       = sum_l A[:, l] b_l[l]          (6W)
// and then, as the Pallas wrapper does, S = blockdiag(H_cc [+ lam I]) - S_off
// and b_red = b_c - b_sub. The inverse uses `_inv9`'s formula and order of
// operations, with no contraction into FMAs, so it is bit-equal to the
// plain version's.
//
// Design (Hopper, sm_90a): one launch per call, of K thread-block clusters
// of C CTAs each (C = 16 where the card schedules a non-portable cluster of
// 16, else 8; `sosvo_schur_cluster_size` decides once; K = 1 up to 32
// landmarks per CTA, more for larger windows, at most as many as the card
// holds at once, so the launch is one wave):
//   * CTA b of the grid walks landmark tiles b, b + K C, ... in order. A
//     tile is T = G m landmarks; the CTA's threads are P = W (W + 1) / 2
//     camera-block pairs (w <= v) times G landmark groups, and thread
//     (pair, group) keeps the pair's 6 x 6 block of S_off and the 6 entries
//     of b_sub[w] in registers, summing landmarks group, group + G, ... of
//     each tile. Only the upper block triangle is computed: S_off's block
//     (v, w) is block (w, v) transposed, so S_off is exactly symmetric
//     across blocks;
//   * loads: the next tile's H_cl, H_ll and b_l arrive by cp.async into the
//     second of two buffers while the current tile is summed. H_cl's
//     landmark stride is 18 floats (72 B) and a slice along L keeps any
//     stride, so TMA (strides that are multiples of 16 B) does not apply:
//     the copies are 8-byte cp.async where the strides and base allow, else
//     4-byte;
//   * per tile, every thread takes landmarks for the inverses, then a
//     fixed row of A (and of a transposed copy of H) for a stride of
//     landmarks, both laid out [landmark][k][row], so the sums read a
//     block's 6 rows as three 8-byte loads and do 36 FMAs for every 6
//     loads. The loops are unrolled: with one CTA of 16 warps per SM they
//     are latency-bound, not issue-bound;
//   * at the end each CTA sums its groups into a partial in shared memory
//     (four chains over groups g = 0, 1, 2, 3 mod 4, each in group order,
//     then (c0 + c1) + (c2 + c3)), cluster.sync(), and then reduces a fixed slice of the
//     entries over ranks 0..C-1 in rank order through distributed shared
//     memory (map_shared_rank). A last cluster.sync() keeps every CTA's
//     shared memory alive until the others have read it. With one cluster
//     the slice goes to S_off, S, b_sub and b_red; with K, to the cluster's
//     row of a global scratch, and the CTA that takes the last ticket sums
//     the K rows in cluster order, writes the outputs and resets the ticket
//     (calls on one stream are ordered, so the next call finds it at 0).
// No float atomics: every sum is taken in a fixed order, so two calls on
// the same inputs give bit-identical outputs (LM's accept test
// `cand_cost < cost` would otherwise flip between runs of one tree). One
// cluster of 16 SMs cannot carry a c5 window (W = 8, L = 4096: 33.8 MFLOP)
// in a few microseconds, hence the K clusters.
// No tensor cores: S_off has to stay within ~3.5e-7 (relative) of the plain
// f32 version, which TF32's 10 mantissa bits cannot give, and the work is
// 1.8 MFLOP at W=5, L=512 and 33.8 MFLOP at W=8, L=4096, microseconds of
// f32 FMA on the clusters' SMs.
//
// Bound on the card: bytes, at every main-path shape
// (sosvo_torch/tools/bounds.py: 0.23 MB, 0.069 us at W=5, L=512). A single
// launch of a few microseconds dwarfs it; the design removes the two-pass
// version's second launch, its serial loads and (with one cluster) its
// global partial rows.
//
// Built by sosvo_torch/kernels/build.py with nvcc into the package's shared
// library with a plain C interface.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kSlots = 42;                 // per block pair: 36 of S_off, 6 of b_sub
constexpr int kMaxSmem = 140 * 1024;       // bytes of dynamic shared memory per CTA
constexpr int kMaxCluster = 16;            // CTAs per cluster, at most
constexpr int kMaxClusters = 16;           // clusters per launch, at most
constexpr int kMaxDevices = 64;

// `_inv9` of sosvo/kernels/schur_pallas.py: h row-major, lam on the diagonal.
__device__ __forceinline__ void inv9(const float h[9], float lam, float out[9]) {
  const float a = __fadd_rn(h[0], lam), b = h[1], c = h[2];
  const float d = h[3], e = __fadd_rn(h[4], lam), f = h[5];
  const float g = h[6], hh = h[7], i = __fadd_rn(h[8], lam);
  const float A = __fsub_rn(__fmul_rn(e, i), __fmul_rn(f, hh));
  const float B = -__fsub_rn(__fmul_rn(d, i), __fmul_rn(f, g));
  const float C = __fsub_rn(__fmul_rn(d, hh), __fmul_rn(e, g));
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(a, A), __fmul_rn(b, B)), __fmul_rn(c, C));
  const float inv_det = 1.0f / det;
  const float adj[9] = {
      A, -__fsub_rn(__fmul_rn(b, i), __fmul_rn(c, hh)), __fsub_rn(__fmul_rn(b, f), __fmul_rn(c, e)),
      B, __fsub_rn(__fmul_rn(a, i), __fmul_rn(c, g)), -__fsub_rn(__fmul_rn(a, f), __fmul_rn(c, d)),
      C, -__fsub_rn(__fmul_rn(a, hh), __fmul_rn(b, g)), __fsub_rn(__fmul_rn(a, e), __fmul_rn(b, d))};
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = __fmul_rn(adj[k], inv_det);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Block pair p (0 <= p < W (W + 1) / 2) -> (w, v), w <= v, row-major over
// the upper block triangle.
__device__ __forceinline__ void pair_of(int p, int W, int& w, int& v) {
  w = 0;
  while (p >= W - w) {
    p -= W - w;
    ++w;
  }
  v = w + p;
}

// Entry e of the reduced sums (pair e / kSlots, slot e % kSlots) into the
// outputs: an S_off entry of block (w, v), mirrored into block (v, w), and S
// beside it; or, for a diagonal pair, an entry of b_sub and b_red.
__device__ __forceinline__ void write_entry(int e, float s, int W, const float* __restrict__ H_cc,
                                            const float* __restrict__ b_c, float lam,
                                            int damp_H_cc, float* __restrict__ S_off,
                                            float* __restrict__ b_sub, float* __restrict__ S,
                                            float* __restrict__ b_red) {
  const int pp = e / kSlots;
  const int slot = e - kSlots * pp;
  int bw, bv;
  pair_of(pp, W, bw, bv);
  if (slot < 36) {
    const int i = slot / 6;
    const int j = slot - 6 * i;
    const int o = ((bw * W + bv) * 6 + i) * 6 + j;  // (W, W, 6, 6) block layout
    float diag = 0.0f;
    if (bw == bv) {
      diag = H_cc[(bw * 6 + i) * 6 + j];
      if (damp_H_cc && i == j) diag += lam;
    }
    S_off[o] = s;
    S[o] = diag - s;
    if (bw != bv) {
      const int o2 = ((bv * W + bw) * 6 + j) * 6 + i;
      S_off[o2] = s;
      S[o2] = 0.0f - s;
    }
  } else if (bw == bv) {
    const int r = 6 * bw + slot - 36;
    b_sub[r] = s;
    b_red[r] = b_c[r] - s;
  }
}

__host__ __device__ constexpr int smem_floats(int W, int T, int G) {
  // two raw tile buffers (H_cl, H_ll, b_l), A and H transposed, inverses and
  // b_l; afterwards the groups' sums and the CTA's partial.
  return (T * (72 * W + 36)) > ((G + 1) * (W * (W + 1) / 2) * kSlots)
             ? T * (72 * W + 36)
             : (G + 1) * (W * (W + 1) / 2) * kSlots;
}

__global__ void __launch_bounds__(kThreads, 1)
schur_cluster_kernel(const float* __restrict__ H_cl, long long stride_w, long long stride_l,
                     const float* __restrict__ H_ll, const float* __restrict__ b_l,
                     const float* __restrict__ H_cc, const float* __restrict__ b_c,
                     const float* __restrict__ lam_ptr, float lam_value, int W, int L, int T,
                     int G, int damp_H_cc, float* __restrict__ H_ll_inv,
                     float* __restrict__ S_off, float* __restrict__ b_sub,
                     float* __restrict__ S, float* __restrict__ b_red,
                     float* __restrict__ cl_part, unsigned int* __restrict__ ticket) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int n = 6 * W;
  const int P = W * (W + 1) / 2;
  const int raw_floats = T * (18 * W + 12);
  float* const sAT = smem + 2 * raw_floats;  // [T][3][n]
  float* const sHT = sAT + 3 * T * n;        // [T][3][n]
  float* const sInv = sHT + 3 * T * n;       // [T][9]
  float* const sB = sInv + 9 * T;            // [T][3]
  const float lam = lam_ptr ? *lam_ptr : lam_value;
  const bool vec2 = ((reinterpret_cast<uintptr_t>(H_cl) & 7) | (stride_w & 1) | (stride_l & 1)) == 0;

  const int pair = tid % P;
  const int group = tid / P;
  const bool active = group < G;
  int w, v;
  pair_of(pair, W, w, v);
  // The A step's items: row r of landmarks t0, t0 + t_step, ...
  const int t_step = kThreads / n;
  const int a_row = tid % n;
  const int a_t0 = tid < t_step * n ? tid / n : kThreads;
  float acc[36], bacc[6];
#pragma unroll
  for (int k = 0; k < 36; ++k) acc[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) bacc[k] = 0.f;

  const int n_tiles = (L + T - 1) / T;
  // raw layout: H [T][W][18] (= [T][n][3]), then H_ll [T][9], then b_l [T][3]
  auto load = [&](int tile, float* buf) {
    const int l0 = tile * T;
    const int tv = min(T, L - l0);
    for (int ww = 0; ww < W; ++ww) {
      const float* src = H_cl + ww * stride_w + static_cast<long long>(l0) * stride_l;
      if (vec2) {
        for (int idx = tid; idx < tv * 9; idx += kThreads) {
          const int t = idx / 9;
          const int q = idx - 9 * t;
          cp_async8(buf + (t * W + ww) * 18 + 2 * q, src + t * stride_l + 2 * q);
        }
      } else {
        for (int idx = tid; idx < tv * 18; idx += kThreads) {
          const int t = idx / 18;
          const int q = idx - 18 * t;
          cp_async4(buf + (t * W + ww) * 18 + q, src + t * stride_l + q);
        }
      }
    }
    float* hll = buf + T * 18 * W;
    for (int idx = tid; idx < tv * 9; idx += kThreads) cp_async4(hll + idx, H_ll + 9LL * l0 + idx);
    float* bl = hll + 9 * T;
    for (int idx = tid; idx < tv * 3; idx += kThreads) cp_async4(bl + idx, b_l + 3LL * l0 + idx);
    cp_async_commit();
  };

  const int n_ctas = gridDim.x;
  if (static_cast<int>(blockIdx.x) < n_tiles) load(blockIdx.x, smem);
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += n_ctas, ++it) {
    const float* buf = smem + (it & 1) * raw_floats;
    if (tile + n_ctas < n_tiles) {
      load(tile + n_ctas, smem + ((it + 1) & 1) * raw_floats);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int l0 = tile * T;
    const int tv = min(T, L - l0);
    const float* rH = buf;
    const float* rHll = buf + T * 18 * W;
    const float* rB = rHll + 9 * T;

    for (int t = tid; t < tv; t += kThreads) {
      float h[9], inv[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) h[k] = rHll[9 * t + k];
      inv9(h, lam, inv);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        sInv[9 * t + k] = inv[k];
        H_ll_inv[9LL * (l0 + t) + k] = inv[k];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) sB[3 * t + k] = rB[3 * t + k];
    }
    __syncthreads();

    // A[t, r, :] = H[t, r, :] @ inv[t], and H, both to [t][k][r]
#pragma unroll 4
    for (int t = a_t0; t < tv; t += t_step) {
      const float* h = rH + 3 * (t * n + a_row);
      const float* iv = sInv + 9 * t;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sAT[(3 * t + k) * n + a_row] = h[0] * iv[k] + h[1] * iv[3 + k] + h[2] * iv[6 + k];
        sHT[(3 * t + k) * n + a_row] = h[k];
      }
    }
    __syncthreads();

    if (active) {
#pragma unroll 2
      for (int t = group; t < tv; t += G) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float2* pa = reinterpret_cast<const float2*>(sAT + (3 * t + k) * n + 6 * w);
          const float2* ph = reinterpret_cast<const float2*>(sHT + (3 * t + k) * n + 6 * v);
          const float2 a0 = pa[0], a1 = pa[1], a2 = pa[2];
          const float2 h0 = ph[0], h1 = ph[1], h2 = ph[2];
          const float a[6] = {a0.x, a0.y, a1.x, a1.y, a2.x, a2.y};
          const float hv[6] = {h0.x, h0.y, h1.x, h1.y, h2.x, h2.y};
          const float bl = sB[3 * t + k];
#pragma unroll
          for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int j = 0; j < 6; ++j) acc[6 * i + j] = fmaf(a[i], hv[j], acc[6 * i + j]);
            bacc[i] = fmaf(a[i], bl, bacc[i]);
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites sInv, sAT, sHT and this raw buffer
  }

  // The CTA's partial: its groups summed in group order.
  float* const red = smem;                 // [G][P][kSlots]
  float* const part = smem + G * P * kSlots;  // [P][kSlots]
  if (active) {
    float* o = red + (group * P + pair) * kSlots;
#pragma unroll
    for (int k = 0; k < 36; ++k) o[k] = acc[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) o[36 + k] = bacc[k];
  }
  __syncthreads();
  for (int e = tid; e < P * kSlots; e += kThreads) {
    // four interleaved chains (groups g = j mod 4), then (c0 + c1) + (c2 + c3)
    const int stride = P * kSlots;
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
    int gg = 0;
    for (; gg + 4 <= G; gg += 4) {
      c0 += red[gg * stride + e];
      c1 += red[(gg + 1) * stride + e];
      c2 += red[(gg + 2) * stride + e];
      c3 += red[(gg + 3) * stride + e];
    }
    if (gg < G) c0 += red[gg * stride + e];
    if (gg + 1 < G) c1 += red[(gg + 1) * stride + e];
    if (gg + 2 < G) c2 += red[(gg + 2) * stride + e];
    part[e] = (c0 + c1) + (c2 + c3);
  }
  cluster.sync();

  // This rank's slice of the entries, summed over ranks 0..C-1 in order.
  const int E = P * kSlots;
  const int per = (E + C - 1) / C;
  const int e1 = min(E, (rank + 1) * per);
  for (int e = rank * per + tid; e < e1; e += kThreads) {
    float r[kMaxCluster];  // all remote loads in flight at once, then summed in rank order
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) r[q] = q < C ? cluster.map_shared_rank(part, q)[e] : 0.f;
    float s = r[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) s = q < C ? s + r[q] : s;
    if (gridDim.x == C) {
      write_entry(e, s, W, H_cc, b_c, lam, damp_H_cc, S_off, b_sub, S, b_red);
    } else {
      cl_part[static_cast<long long>(blockIdx.x / C) * E + e] = s;
    }
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
  if (gridDim.x == C) return;

  // Several clusters: the CTA that finishes last sums their partials in
  // cluster order.
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int K = gridDim.x / C;
  for (int e = tid; e < E; e += kThreads) {
    float r[kMaxClusters];  // all loads in flight at once, then summed in cluster order
#pragma unroll
    for (int k = 0; k < kMaxClusters; ++k)
      r[k] = k < K ? __ldcg(&cl_part[static_cast<long long>(k) * E + e]) : 0.f;
    float s = r[0];
#pragma unroll
    for (int k = 1; k < kMaxClusters; ++k) s = k < K ? s + r[k] : s;
    write_entry(e, s, W, H_cc, b_c, lam, damp_H_cc, S_off, b_sub, S, b_red);
  }
  if (tid == 0) *ticket = 0u;
}

// Per device, decided at its first call: the chosen cluster size plus one
// (0: not yet decided), and the clusters of that size it holds at once.
int g_cluster[kMaxDevices];
int g_resident[kMaxDevices];

}  // namespace

// The cluster size the kernel launches with on the current device: 16 CTAs
// where the card schedules a non-portable cluster of 16 at the kernel's
// largest shared memory, else 8 (the portable limit), 0 if neither
// schedules. Decided at the device's first call, which also sets the
// kernel's attributes there; later calls return the same. A cluster's CTAs
// share one GPC, so the card may hold fewer clusters of 16 at once than
// its SMs / 16: sosvo_schur_resident_clusters says how many.
extern "C" int sosvo_schur_cluster_size() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) {
    cudaGetLastError();
    return 0;
  }
  if (g_cluster[dev] > 0) return g_cluster[dev] - 1;
  g_cluster[dev] = 1;
  if (cudaFuncSetAttribute(schur_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
          cudaSuccess ||
      cudaFuncSetAttribute(schur_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  for (int c : {16, 8}) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kMaxSmem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n_clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&n_clusters, schur_cluster_kernel, &cfg) == cudaSuccess &&
        n_clusters > 0) {
      g_cluster[dev] = c + 1;
      g_resident[dev] = n_clusters;
      break;
    }
  }
  cudaGetLastError();
  return g_cluster[dev] - 1;
}

// The clusters of sosvo_schur_cluster_size's size that the current device
// runs at once (one CTA per SM): a launch of more would run in two waves.
extern "C" int sosvo_schur_resident_clusters() {
  int dev = 0;
  if (sosvo_schur_cluster_size() == 0 || cudaGetDevice(&dev) != cudaSuccess) return 0;
  return g_resident[dev];
}

// Launches the one-cluster kernel on `stream`; returns the launch status
// (cudaGetLastError) as an int, 0 on success. `lam` is a device pointer to
// one float, or null, and then `lam_value` is lam. Strides are in floats.
// `tile` landmarks per tile, `groups` landmark groups per CTA and `cluster`
// (from sosvo_schur_cluster_size) come from the wrapper's schedule.
extern "C" int sosvo_schur_reduce(const void* H_cl, long long stride_w, long long stride_l,
                                  const void* H_ll, const void* b_l, const void* H_cc,
                                  const void* b_c, const void* lam, float lam_value, int W, int L,
                                  int tile, int groups, int cluster, int clusters, int damp_H_cc,
                                  void* H_ll_inv, void* S_off, void* b_sub, void* S, void* b_red,
                                  void* cl_part, void* ticket, void* stream) {
  const int P = W * (W + 1) / 2;
  if (W <= 0 || L <= 0 || tile <= 0 || groups <= 0 || groups * P > kThreads ||
      cluster != sosvo_schur_cluster_size() || cluster == 0 || clusters <= 0 ||
      clusters > kMaxClusters)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats(W, tile, groups));
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, schur_cluster_kernel, static_cast<const float*>(H_cl), stride_w, stride_l,
      static_cast<const float*>(H_ll), static_cast<const float*>(b_l),
      static_cast<const float*>(H_cc), static_cast<const float*>(b_c),
      static_cast<const float*>(lam), lam_value, W, L, tile, groups, damp_H_cc,
      static_cast<float*>(H_ll_inv), static_cast<float*>(S_off), static_cast<float*>(b_sub),
      static_cast<float*>(S), static_cast<float*>(b_red), static_cast<float*>(cl_part),
      static_cast<unsigned int*>(ticket));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
