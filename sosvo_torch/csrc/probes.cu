// Probes for the measurement tools (sosvo_torch/tools/), not kernels of the
// pipeline:
//   * an empty kernel, launched through the same ctypes route as the
//     pipeline's kernels: its device time and its wrapper time are the
//     launch floor that no one-launch kernel of this library can beat;
//   * the floors of the two kernels' own patterns, with no work in them:
//     the matcher's grid whose last block is found by a ticket (its column
//     decode) and one cluster launch with two cluster.sync() (the Schur
//     reduction's);
//   * tensor-core throughput loops in the b1 AND/popc form the matcher's
//     work can take and in int8, each through mma.sync (m16n8k256 b1,
//     m16n8k32 int8: the matcher's instruction) and through wgmma
//     (m64n256k256 b1, m64n256k32 int8, both operands in shared memory):
//     NVIDIA's data sheet gives no b1 rate, so sosvo_torch/tools/mma_rate.py
//     measures it for the matcher's bound (sosvo_torch/tools/bounds.py), and
//     the int8 loops show how near each form comes to the data sheet's int8
//     rate.
//
// Built by sosvo_torch/kernels/build.py with the other sources.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

extern "C" int sosvo_schur_cluster_size();
extern "C" int sosvo_match_grid(int ka, int kb, int* grid);

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 4;        // independent mma.sync accumulators per warp: enough to fill the pipe
constexpr int kWgmmaPerGroup = 4; // wgmma per commit group; one group stays in flight
constexpr int kMaxDevices = 64;

// Throughput loops: 0 mma.sync int8, 1 mma.sync b1, 2 wgmma int8, 3 wgmma b1.
enum Kind { kSyncInt8 = 0, kSyncB1 = 1, kWgmmaInt8 = 2, kWgmmaB1 = 3 };

__global__ void empty_kernel() {}

// Every block fences and takes a ticket; the last one resets it.
__global__ void ticket_kernel(unsigned int* __restrict__ ticket) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (s_last && threadIdx.x == 0) {
    __threadfence();
    *ticket = 0u;
  }
}

__global__ void cluster_kernel() {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) smem[0] = 0.f;
  cluster.sync();
  cluster.sync();
}

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kB1>
__global__ void __launch_bounds__(kThreads) mma_rate_kernel(int iters, int* __restrict__ out) {
  const uint32_t t = threadIdx.x + blockIdx.x * blockDim.x;
  const uint32_t a[4] = {t * 2654435761u, t ^ 0x9e3779b9u, ~t, t * 40503u};
  const uint32_t b0 = t * 2246822519u, b1 = t ^ 0x85ebca6bu;
  int acc[kChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (kB1) {
        mma_b1(acc[c], a, b0 + c, b1);
      } else {
        mma_s8(acc[c], a, b0 + c, b1);
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[t] = s;
}

// wgmma, m64n256 with both operands in shared memory: one warpgroup's 64 x
// 256 tile of s32 sums, 128 registers a thread.
#define SOSVO_WGMMA_D \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"\
  "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"\
  "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"\
  "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"\
  "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"\
  "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"\
  "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"\
  "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, "
#define SOSVO_WGMMA_OUT \
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), \
      "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
      "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), \
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), \
      "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), \
      "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), \
      "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), \
      "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), \
      "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])

// One wgmma into d, accumulating: b1 AND/popc at k = 256 bits, or int8 at k
// = 32 bytes. Both read 32 bytes a row, so the same descriptors serve.
template <bool kB1>
__device__ __forceinline__ void wgmma_m64n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  if (kB1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc "
        SOSVO_WGMMA_D "%128, %129, p;\n}\n"
        : SOSVO_WGMMA_OUT
        : "l"(desc_a), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        SOSVO_WGMMA_D "%128, %129, p;\n}\n"
        : SOSVO_WGMMA_OUT
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
}

// A shared-memory matrix descriptor, no swizzle: 8-row x 16-byte core
// matrices of 128 B; the two core matrices of a row group's 32 bytes lie
// 128 B apart (leading byte offset), row groups 256 B apart (stride byte
// offset).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

// Two warpgroups a block, each `iters` x kWgmmaPerGroup wgmma of its own A
// (64 rows) against the block's B (256 rows), one commit group in flight.
template <bool kB1>
__global__ void __launch_bounds__(kThreads, 1) wgmma_rate_kernel(int iters, int* __restrict__ out) {
  __shared__ __align__(128) uint32_t s_a[2][64 * 8];
  __shared__ __align__(128) uint32_t s_b[256 * 8];
  for (int i = threadIdx.x; i < 2 * 64 * 8; i += blockDim.x) (&s_a[0][0])[i] = i * 2654435761u;
  for (int i = threadIdx.x; i < 256 * 8; i += blockDim.x) s_b[i] = (i * 2246822519u) ^ blockIdx.x;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // stores -> wgmma's reads
  __syncthreads();
  const uint64_t da = smem_desc(s_a[threadIdx.x / 128]), db = smem_desc(s_b);
  int d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kWgmmaPerGroup; ++j) wgmma_m64n256<kB1>(d, da, db);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int s = 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int g_cluster_smem[kMaxDevices];  // per device: the probe's shared memory set up, plus one (0: none)

}  // namespace

extern "C" int sosvo_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// `blocks` blocks of 256 threads running the throughput loop `kind` (Kind
// above) `iters` times; `out` holds blocks * 256 ints. mma.sync: each warp
// kChains mma a step; wgmma: each warpgroup kWgmmaPerGroup a step, 128
// accumulator registers a thread, so one block per SM.
extern "C" int sosvo_mma_rate(int kind, int blocks, int iters, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  switch (kind) {
    case kSyncInt8: mma_rate_kernel<false><<<blocks, kThreads, 0, st>>>(iters, o); break;
    case kSyncB1: mma_rate_kernel<true><<<blocks, kThreads, 0, st>>>(iters, o); break;
    case kWgmmaInt8: wgmma_rate_kernel<false><<<blocks, kThreads, 0, st>>>(iters, o); break;
    case kWgmmaB1: wgmma_rate_kernel<true><<<blocks, kThreads, 0, st>>>(iters, o); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The operations one sosvo_mma_rate launch does, two per multiply-add as
// the data sheet's int8 rate counts them (per bit pair for b1).
extern "C" double sosvo_mma_rate_ops(int kind, int blocks, int iters) {
  const bool b1 = kind == kSyncB1 || kind == kWgmmaB1;
  const double k = b1 ? 256.0 : 32.0;  // one 32-byte row of either operand
  const double per_step = kind >= kWgmmaInt8 ? (kThreads / 128) * kWgmmaPerGroup * 64.0 * 256.0
                                             : (kThreads / 32) * kChains * 16.0 * 8.0;
  return 2.0 * k * per_step * blocks * static_cast<double>(iters);
}

// The matcher's grid at ka x kb (sosvo_match_grid), each block taking a
// ticket and doing nothing else (`ticket` is 0 and is left so).
extern "C" int sosvo_ticket_kernel(int ka, int kb, void* ticket, void* stream) {
  int grid[4];
  const int err = sosvo_match_grid(ka, kb, grid);
  if (err != 0) return err;
  ticket_kernel<<<dim3(grid[0], grid[1]), grid[2], 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

// `clusters` clusters of the Schur kernel's cluster size, 512 threads and
// `smem` bytes of dynamic shared memory per CTA, each CTA doing two
// cluster.sync() and nothing else.
extern "C" int sosvo_cluster_kernel(int clusters, int smem, void* stream) {
  const int c = sosvo_schur_cluster_size();
  int dev = 0;
  if (c == 0 || cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_cluster_smem[dev] != smem + 1) {  // the attributes are set per device and shared-memory size
    if (cudaFuncSetAttribute(cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
            cudaSuccess ||
        cudaFuncSetAttribute(cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
            cudaSuccess)
      return static_cast<int>(cudaGetLastError());
    g_cluster_smem[dev] = smem + 1;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c * clusters);
  cfg.blockDim = dim3(512);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
