// Brute-force Hamming matcher statistics for 256-bit binary descriptors.
//
// Replaces the Pallas TPU kernel `sosvo/kernels/match_pallas.py:
// match_stats_pallas` (body `_match_kernel`) and computes exactly what it
// computes: over the penalized distance matrix
//     D[i, j] = hamming(a_i, b_j) + pen_a[i] + pen_b[j] + band_pen[i, j]
// (BIG = 1e9 for an invalid row / column / a pair outside the circular
// azimuth band, added in that order in f32 as `sosvo/frontend/match.py`
// does), each row's minimum, its second minimum (the minimum with the best
// column masked), its argmin, and each column's argmin. Ties go to the lower
// index, as jnp.argmin / torch.argmin do.
//
// Design (Hopper, sm_90a), one launch per call:
//   * distances on the tensor cores: one
//     `mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc` covers the whole
//     256-bit descriptor for a 16 x 8 tile of pairs, and
//         ham = popc(a) + popc(b) - 2 popc(a & b)
//     is exact in int32. The b1 AND form is the route: the PTX ISA lists
//     the b1 XOR form as deprecated, and AND/popc needs no +/-1 expansion
//     to int8 (8x the fragment registers). popc(a & b) does
//     not change under a common permutation of the bit positions, so the two
//     fragments only have to hold the same descriptor word in the same k
//     slot: k slot q (bits 32q..32q+31) holds word 2q and slot q + 4 holds
//     word 2q + 1, so each lane loads a descriptor's words as 8-byte pairs;
//   * the columns are the mma's m16 operand and the rows its n8 operand: a
//     block owns 16 rows (two n8 tiles, so the grid is ceil(Ka / 16)
//     blocks) and its warps split the columns, 16 each out of every block
//     tile. Lane (g, q) = (lane / 4, lane % 4) then holds columns g and
//     g + 8 against rows 2q, 2q + 1, 8 + 2q and 9 + 2q, so a column's
//     minimum over the block's rows takes two shuffle steps, and a row's
//     state is merged across lanes once, at the end;
//   * a warp streams its own columns into its own double buffer in shared
//     memory with 16-byte cp.async, and their validity and azimuth into
//     registers, one tile ahead, so the main loop has no block-wide
//     barrier;
//   * the grid fills the card: where the row tiles leave SMs idle (K = 512
//     has 32 tiles for 132 SMs), the columns are split over up to that many
//     blocks per row tile, and the block that finishes last merges each
//     row's split states. On an H100 the split takes 10 % off K = 512 and
//     21 % off the 1024 x 2048 association against one block per row tile
//     (sosvo_torch/tools/profile_replay.py --kernels). A block has 8, 16 or
//     32 warps, one per 16 columns of its share, and at most 16 when the
//     grid is more than one block per SM, so two fit on each and the grid
//     stays one wave. The SM count is read per device;
//   * the epilogue stays in registers: the penalties are added to the
//     distance in the reference's order, each lane keeps a (best, second,
//     argmin) state per row over the columns it visits in increasing order,
//     and the quads, then the warps, merge the states by butterflies with
//     the lower index winning a tie (the merge is order-free);
//   * column argmin: the key (float bits of d) << 32 | row orders like
//     (d, row) because d >= 0, so a 64-bit atomicMin over it is
//     deterministic: one per column per block. The keys live in a scratch
//     the wrapper allocates once per (device, stream) and fills with ~0 at
//     allocation only, next to a ticket counter. The block that takes the
//     last ticket decodes the keys into the int32 `col_argmin`, resets them
//     to ~0 and the ticket to 0. Calls on one stream are ordered, so the
//     next call finds the scratch clean; two streams get two scratches.
// Bound on the card: the operations, 2 Ka Kb 256 bit operations at the
// fastest measured b1 rate (sosvo_torch/tools/bounds.py). At K <= 2048 the call is a few microseconds of latency: one
// launch, the A and B loads, the per-column atomics (one per block) and the
// last block's decode.
//
// Built by sosvo_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface (no --use_fast_math: the f32 penalty adds must round
// as in the reference).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kRows = 16;                     // rows per block: two n8 tiles
constexpr int kWarpCols = 16;                 // columns per warp per block tile: one m16 tile
constexpr int kMaxSplits = 8;                 // column splits per row tile, at most
constexpr int kMaxDevices = 64;
constexpr float kBig = 1e9f;
constexpr float kPi = 3.14159265358979323846f;     // f32(pi), as the reference's
constexpr float kTwoPi = 6.28318530717958647692f;  // weakly typed constants round

struct RowState {
  float best;
  float second;
  int idx;
};

__device__ __forceinline__ unsigned long long pack_key(float d, int row) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned int>(row);
}

// Columns arrive in increasing order within a lane, so a later equal value
// never displaces the argmin; it only becomes the second-best.
__device__ __forceinline__ void push(RowState& s, float d, int col) {
  if (d < s.best) {
    s.second = s.best;
    s.best = d;
    s.idx = col;
  } else {
    s.second = fminf(s.second, d);
  }
}

// Merge a disjoint column set's state: the winner is the smaller (best, idx);
// the second-best is the smaller of the winner's second and the loser's best.
__device__ __forceinline__ void merge(RowState& s, float ob, float os, int oi) {
  const bool other_wins = (ob < s.best) || (ob == s.best && oi < s.idx);
  if (other_wins) {
    s.second = fminf(os, s.best);
    s.best = ob;
    s.idx = oi;
  } else {
    s.second = fminf(s.second, ob);
  }
}

__device__ __forceinline__ void merge_lanes(RowState& s, int off) {
  const float ob = __shfl_xor_sync(0xffffffffu, s.best, off);
  const float os = __shfl_xor_sync(0xffffffffu, s.second, off);
  const int oi = __shfl_xor_sync(0xffffffffu, s.idx, off);
  merge(s, ob, os, oi);
}

__device__ __forceinline__ unsigned long long min_over_quad(unsigned long long k) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, k, off);
    k = o < k ? o : k;
  }
  return k;
}

// float(h) for 0 <= h < 2^23, exactly, without a conversion instruction.
__device__ __forceinline__ float small_int_to_float(int h) {
  return __int_as_float(0x4B000000 + h) - 8388608.0f;
}

// d = popc(a & b) summed over the 256 bits, for a 16 x 8 tile.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0), "r"(0), "r"(0),
        "r"(0));
}

// 16 bytes from global to shared memory, zero-filled where `full` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 1024 / (kWarps * 32))
match_hamming_kernel(int cols_per_split, float4* __restrict__ row_part,
                     const uint32_t* __restrict__ desc_a,
                     const uint32_t* __restrict__ desc_b,
                     const bool* __restrict__ valid_a,
                     const bool* __restrict__ valid_b,
                     const float* __restrict__ az_a,
                     const float* __restrict__ az_b,
                     int ka, int kb, float band,
                     float* __restrict__ d_best,
                     float* __restrict__ d_second,
                     int* __restrict__ idx_b,
                     int* __restrict__ col_argmin,
                     unsigned long long* __restrict__ col_key,
                     unsigned int* __restrict__ ticket) {
  constexpr int kTileB = kWarps * kWarpCols;  // columns per block tile
  // Per warp: two buffers of its 16 columns, each column's 8 words in a row.
  __shared__ __align__(16) uint32_t s_b[kWarps][2][kWarpCols * kWords];
  __shared__ float s_pen[kWarps][kWarpCols];
  __shared__ float s_az[kWarps][kWarpCols];
  __shared__ int s_pop[kWarps][kWarpCols];
  __shared__ RowState s_row[kRows][kWarps];
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const bool use_band = band > 0.f;
  // This block's columns: split blockIdx.y of the columns (one split when
  // the rows alone fill the card).
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(kb, c_begin + cols_per_split);
  const int n_tiles = (c_end - c_begin + kTileB - 1) / kTileB;

  // Prefetch one tile ahead: the warp's columns' words by cp.async (lane:
  // half a column), and each column's validity and azimuth into the
  // registers of lanes 0..15.
  bool vb_next = false;
  float azb_next = 0.f;
  auto issue = [&](int tile) {
    const int c0 = c_begin + tile * kTileB + warp * kWarpCols;
    const int c = lane >> 1;
    const int col = c0 + c;
    const bool ok = col < c_end;
    cp_async16(&s_b[warp][tile & 1][c * kWords + (lane & 1) * 4],
               desc_b + static_cast<size_t>(ok ? col : 0) * kWords + (lane & 1) * 4, ok);
    cp_async_commit();
    const int mcol = c0 + lane;
    const bool mok = lane < kWarpCols && mcol < c_end;
    vb_next = mok && valid_b[mcol];
    azb_next = (use_band && mok) ? az_b[mcol] : 0.f;
  };
  issue(0);

  // The rows are the mma's n8 operand, two tiles of 8: lane (g, q) holds
  // words 2q and 2q + 1 of rows g and g + 8, and its accumulators cover
  // rows 2q, 2q + 1 (tile 0) and 8 + 2q, 9 + 2q (tile 1): rr[i] below.
  uint32_t b[2][2];
  int rr[4];
  bool row_ok[4];
  float pen_a[4], az_row[4];
  int pop_a[4];
  RowState st[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = blockIdx.x * kRows + g + 8 * h;
    uint2 w = make_uint2(0u, 0u);
    if (r < ka) w = *reinterpret_cast<const uint2*>(desc_a + static_cast<size_t>(r) * kWords + 2 * q);
    b[h][0] = w.x;
    b[h][1] = w.y;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rr[i] = blockIdx.x * kRows + 8 * (i >> 1) + 2 * q + (i & 1);
    row_ok[i] = rr[i] < ka;
    pen_a[i] = (row_ok[i] && valid_a[rr[i]]) ? 0.f : kBig;
    az_row[i] = (use_band && row_ok[i]) ? az_a[rr[i]] : 0.f;
    st[i] = RowState{__int_as_float(0x7f800000), __int_as_float(0x7f800000), INT_MAX};
  }
  {  // each row's popcount: the row's 8 words sit in the 4 lanes of a quad
    int p[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p[h] = __popc(b[h][0]) + __popc(b[h][1]);
      p[h] += __shfl_xor_sync(0xffffffffu, p[h], 1);
      p[h] += __shfl_xor_sync(0xffffffffu, p[h], 2);
    }
    // row 8h + j is held by quad g = j
#pragma unroll
    for (int i = 0; i < 4; ++i) pop_a[i] = __shfl_sync(0xffffffffu, p[i >> 1], (2 * q + (i & 1)) * 4);
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool vb = vb_next;
    const float azb = azb_next;
    if (tile + 1 < n_tiles) {
      issue(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int c0 = c_begin + tile * kTileB + warp * kWarpCols;
    const uint32_t* sb = s_b[warp][tile & 1];
    if (c0 < c_end) {  // warp-uniform
      if (lane < kWarpCols) {  // this warp's column metadata: lane = column
        const uint4 lo = *reinterpret_cast<const uint4*>(sb + lane * kWords);
        const uint4 hi = *reinterpret_cast<const uint4*>(sb + lane * kWords + 4);
        s_pop[warp][lane] = __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) +
                            __popc(hi.x) + __popc(hi.y) + __popc(hi.z) + __popc(hi.w);
        s_pen[warp][lane] = vb ? 0.f : kBig;
        s_az[warp][lane] = azb;
      }
      __syncwarp();
      // The columns are the mma's m16 operand: lane (g, q) gives words 2q,
      // 2q + 1 of columns g and g + 8 (a0, a2 column g; a1, a3 column g + 8).
      const uint2 x0 = *reinterpret_cast<const uint2*>(sb + g * kWords + 2 * q);
      const uint2 x1 = *reinterpret_cast<const uint2*>(sb + (g + 8) * kWords + 2 * q);
      const uint32_t a[4] = {x0.x, x1.x, x0.y, x1.y};
      int acc[2][4];
      mma_and_popc(acc[0], a, b[0][0], b[0][1]);
      mma_and_popc(acc[1], a, b[1][0], b[1][1]);
      unsigned long long key[2] = {~0ull, ~0ull};
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // column g + 8 j, visited in increasing order
        const int cl = g + 8 * j;
        const int col = c0 + cl;
        const int pop_b = s_pop[warp][cl];
        const float pen_b = s_pen[warp][cl];
        const float az_col = s_az[warp][cl];
        if (col < c_end) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // acc[tile i / 2][2 j + i % 2]: row rr[i]
            const int ham = pop_a[i] + pop_b - 2 * acc[i >> 1][2 * j + (i & 1)];
            float d = small_int_to_float(ham);
            d = d + pen_a[i];
            d = d + pen_b;
            if (use_band) {
              float diff = az_row[i] - az_col;
              if (diff > kPi) diff = diff - kTwoPi;
              if (diff < -kPi) diff = diff + kTwoPi;
              d = d + (fabsf(diff) <= band ? 0.f : kBig);
            }
            push(st[i], d, col);
            if (row_ok[i]) {
              const unsigned long long k = pack_key(d, rr[i]);
              key[j] = k < key[j] ? k : key[j];
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned long long k = min_over_quad(key[j]);
        const int col = c0 + g + 8 * j;
        if (q == 0 && col < c_end) atomicMin(&col_key[col], k);
      }
    }
    __syncwarp();  // the buffer is refilled two tiles on
  }

  // Rows' states: over the 8 quads' column sets, then over the warps. The
  // merge is order-free (the winner is the smallest (best, idx), the second
  // the smallest of the rest), so butterflies.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    merge_lanes(st[i], 4);
    merge_lanes(st[i], 8);
    merge_lanes(st[i], 16);
    if (g == 0) s_row[8 * (i >> 1) + 2 * q + (i & 1)][warp] = st[i];
  }
  __syncthreads();
  for (int rw = warp; rw < kRows; rw += kWarps) {  // warp rw merges row rw over the warps
    RowState s = lane < kWarps ? s_row[rw][lane]
                               : RowState{__int_as_float(0x7f800000), __int_as_float(0x7f800000), INT_MAX};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) merge_lanes(s, off);
    const int r = blockIdx.x * kRows + rw;
    if (lane == 0 && r < ka) {
      if (gridDim.y == 1) {
        d_best[r] = s.best;
        d_second[r] = s.second;
        idx_b[r] = s.idx;
      } else {  // the last block merges the splits
        row_part[r * gridDim.y + blockIdx.y] = make_float4(s.best, s.second, __int_as_float(s.idx), 0.f);
      }
    }
  }
  __threadfence();  // this thread's atomics reach the device before the ticket
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (s_last) {  // every block's writes are in: decode, and leave the scratch clean
    __threadfence();
    const int splits = gridDim.y;
    if (splits > 1) {
      for (int r = tid; r < ka; r += blockDim.x) {
        float4 v[kMaxSplits];  // every split's state in flight at once
#pragma unroll
        for (int y = 0; y < kMaxSplits; ++y)
          if (y < splits) v[y] = __ldcg(&row_part[r * splits + y]);
        RowState s{v[0].x, v[0].y, __float_as_int(v[0].z)};
#pragma unroll
        for (int y = 1; y < kMaxSplits; ++y)
          if (y < splits) merge(s, v[y].x, v[y].y, __float_as_int(v[y].z));
        d_best[r] = s.best;
        d_second[r] = s.second;
        idx_b[r] = s.idx;
      }
    }
#pragma unroll 4
    for (int col = tid; col < kb; col += blockDim.x) {
      const unsigned long long k = __ldcg(&col_key[col]);
      col_argmin[col] = static_cast<int>(k & 0xffffffffull);
      col_key[col] = ~0ull;
    }
    if (tid == 0) *ticket = 0u;
  }
}

int g_sms[kMaxDevices];  // per device: its SMs, read at its first launch

}  // namespace

// The matcher's launch at ka x kb on the current device: grid[0] row tiles
// times grid[1] column splits, blocks of grid[2] threads, and grid[3]
// columns per split. Returns a CUDA error code, 0 on success.
extern "C" int sosvo_match_grid(int ka, int kb, int* grid) {
  int dev = 0;
  if (ka <= 0 || kb <= 0 || cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g_sms[dev] == 0 &&
      cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int sms = g_sms[dev];
  // Row tiles first; where they leave SMs idle, the columns are split over
  // up to that many blocks per row tile (at least 128 columns each).
  const int row_blocks = (ka + kRows - 1) / kRows;
  int splits = 1;
  if (row_blocks < sms) splits = max(1, min(min(sms / row_blocks, kMaxSplits), (kb + 127) / 128));
  const int cols = ((kb + splits - 1) / splits + kWarpCols - 1) / kWarpCols * kWarpCols;
  splits = (kb + cols - 1) / cols;
  // Warps: as many 16-column slices as a block tile needs, 8 to 32; 16 at
  // most when the grid is more than one block per SM, so two fit on each.
  const int need = (cols + kWarpCols - 1) / kWarpCols;
  int warps = need > 16 ? 32 : need > 8 ? 16 : 8;
  if (row_blocks * splits > sms && warps > 16) warps = 16;
  grid[0] = row_blocks;
  grid[1] = splits;
  grid[2] = warps * 32;
  grid[3] = cols;
  return 0;
}

// Launches on `stream`; returns the launch status (cudaGetLastError) as an
// int, 0 on success. `az_a`/`az_b` may be null when band <= 0. `col_key`
// holds at least kb keys equal to ~0 and `ticket` is 0, as the previous call
// on the stream left them; `row_part` has room for 16 x (the card's SMs)
// float4 (row tiles x splits <= SMs) and needs no initial value. desc_a must
// be 8-byte and desc_b 16-byte aligned, row_part 16-byte aligned.
extern "C" int sosvo_match_hamming(const void* desc_a, const void* desc_b,
                                   const void* valid_a, const void* valid_b,
                                   const void* az_a, const void* az_b,
                                   int ka, int kb, float band,
                                   void* d_best, void* d_second, void* idx_b, void* col_argmin,
                                   void* col_key, void* ticket, void* row_part, void* stream) {
  int grid[4];
  const int err = sosvo_match_grid(ka, kb, grid);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {
    kernel<<<dim3(grid[0], grid[1]), grid[2], 0, st>>>(
        grid[3], static_cast<float4*>(row_part),
        static_cast<const uint32_t*>(desc_a), static_cast<const uint32_t*>(desc_b),
        static_cast<const bool*>(valid_a), static_cast<const bool*>(valid_b),
        static_cast<const float*>(az_a), static_cast<const float*>(az_b), ka, kb, band,
        static_cast<float*>(d_best), static_cast<float*>(d_second), static_cast<int*>(idx_b),
        static_cast<int*>(col_argmin), static_cast<unsigned long long*>(col_key),
        static_cast<unsigned int*>(ticket));
  };
  if (grid[2] == 32 * 32) {
    launch(match_hamming_kernel<32>);
  } else if (grid[2] == 16 * 32) {
    launch(match_hamming_kernel<16>);
  } else {
    launch(match_hamming_kernel<8>);
  }
  return static_cast<int>(cudaGetLastError());
}
