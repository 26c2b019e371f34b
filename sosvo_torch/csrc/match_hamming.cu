// Brute-force Hamming matcher statistics for 256-bit binary descriptors.
//
// Replaces the Pallas TPU kernel `sosvo/kernels/match_pallas.py:
// match_stats_pallas` (body `_match_kernel`) and computes exactly what it
// computes: over the penalized distance matrix
//     D[i, j] = hamming(a_i, b_j) + pen_a[i] + pen_b[j] + band_pen[i, j]
// (BIG = 1e9 for an invalid row / column / a pair outside the circular
// azimuth band, added in that order as `sosvo/frontend/match.py` does), each
// row's minimum, its second minimum (the minimum with the best column
// masked), its argmin, and each column's argmin. Ties go to the lower index,
// as jnp.argmin / torch.argmin do.
//
// Design (Hopper, sm_90a): the TPU kernel streamed B tiles through VMEM into
// a bf16 +/-1 MXU matmul and carried column minima across sequential grid
// steps. Here blocks run in no order, so:
//   * a block owns ROWS_PER_BLOCK rows of A; each warp owns ROWS_PER_WARP of
//     them, with the rows' 8 words held in registers by every lane;
//   * B streams through shared memory in TILE_B-column tiles, stored
//     word-major so lanes read consecutive banks;
//   * a distance is 8 XORs + 8 __popc: exact, no tensor cores;
//   * each lane keeps a (best, second, argmin) state per row over the columns
//     it visits in increasing order; the warp merges the 32 lane states by
//     shuffles at the end (lower index wins a tie);
//   * column argmin: a key (float bits of d) << 32 | row orders like (d, row)
//     because d >= 0. The block reduces its warps' keys per column in shared
//     memory, then issues one 64-bit atomicMin per column into a buffer the
//     caller filled with ~0.
// Bound on the card: at K <= 2048 the work is K^2 * ~20 integer ops (tens of
// microseconds of ALU at most) and the descriptors are 32 bytes per feature,
// so launch latency and the per-column atomics bound it, not bytes or
// FLOPs. Tensor cores (+/-1 int8 / wgmma) are later work.
//
// Built by sosvo_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface (no --use_fast_math: the f32 penalty adds must round
// as in the reference).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTileB = 256;
constexpr int kColsPerLane = kTileB / 32;
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

__global__ void __launch_bounds__(kWarps * 32)
match_hamming_kernel(const uint32_t* __restrict__ desc_a,
                     const uint32_t* __restrict__ desc_b,
                     const bool* __restrict__ valid_a,
                     const bool* __restrict__ valid_b,
                     const float* __restrict__ az_a,
                     const float* __restrict__ az_b,
                     int ka, int kb, float band,
                     float* __restrict__ d_best,
                     float* __restrict__ d_second,
                     int* __restrict__ idx_b,
                     unsigned long long* __restrict__ col_key) {
  __shared__ uint32_t s_b[kWords][kTileB + 1];
  __shared__ float s_pen_b[kTileB];
  __shared__ float s_az_b[kTileB];
  __shared__ unsigned long long s_key[kWarps][kTileB];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool use_band = band > 0.f;

  uint32_t a[kRowsPerWarp][kWords];
  float pen_a[kRowsPerWarp];
  float az_row[kRowsPerWarp];
  int row[kRowsPerWarp];
  bool row_ok[kRowsPerWarp];
  RowState st[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    row[r] = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + r;
    row_ok[r] = row[r] < ka;
    const int rr = row_ok[r] ? row[r] : 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) a[r][w] = desc_a[static_cast<size_t>(rr) * kWords + w];
    pen_a[r] = valid_a[rr] ? 0.f : kBig;
    az_row[r] = use_band ? az_a[rr] : 0.f;
    st[r] = RowState{__int_as_float(0x7f800000), __int_as_float(0x7f800000), INT_MAX};
  }

  for (int j0 = 0; j0 < kb; j0 += kTileB) {
    for (int i = tid; i < kTileB * kWords; i += blockDim.x) {
      const int c = i / kWords;
      const int w = i % kWords;
      const int col = j0 + c;
      s_b[w][c] = col < kb ? desc_b[static_cast<size_t>(col) * kWords + w] : 0u;
    }
    for (int c = tid; c < kTileB; c += blockDim.x) {
      const int col = j0 + c;
      s_pen_b[c] = (col < kb && valid_b[col]) ? 0.f : kBig;
      s_az_b[c] = (use_band && col < kb) ? az_b[col] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kColsPerLane; ++k) {
      const int c = k * 32 + lane;
      const int col = j0 + c;
      unsigned long long key = ~0ull;
      if (col < kb) {
        uint32_t b[kWords];
#pragma unroll
        for (int w = 0; w < kWords; ++w) b[w] = s_b[w][c];
        const float pb = s_pen_b[c];
        const float azb = s_az_b[c];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          if (!row_ok[r]) continue;
          int h = 0;
#pragma unroll
          for (int w = 0; w < kWords; ++w) h += __popc(a[r][w] ^ b[w]);
          float d = static_cast<float>(h);
          d = d + pen_a[r];
          d = d + pb;
          if (use_band) {
            float diff = az_row[r] - azb;
            if (diff > kPi) diff = diff - kTwoPi;
            if (diff < -kPi) diff = diff + kTwoPi;
            d = d + (fabsf(diff) <= band ? 0.f : kBig);
          }
          push(st[r], d, col);
          const unsigned long long kr = pack_key(d, row[r]);
          key = kr < key ? kr : key;
        }
      }
      s_key[warp][c] = key;
    }
    __syncthreads();

    for (int c = tid; c < kTileB; c += blockDim.x) {
      const int col = j0 + c;
      if (col < kb) {
        unsigned long long m = s_key[0][c];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) m = s_key[w][c] < m ? s_key[w][c] : m;
        if (m != ~0ull) atomicMin(&col_key[col], m);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, st[r].best, off);
      const float os = __shfl_xor_sync(0xffffffffu, st[r].second, off);
      const int oi = __shfl_xor_sync(0xffffffffu, st[r].idx, off);
      merge(st[r], ob, os, oi);
    }
    if (lane == 0 && row_ok[r]) {
      d_best[row[r]] = st[r].best;
      d_second[row[r]] = st[r].second;
      idx_b[row[r]] = st[r].idx;
    }
  }
}

}  // namespace

// Launches on `stream`; returns the launch status (cudaGetLastError) as an
// int, 0 on success. `az_a`/`az_b` may be null when band <= 0.
extern "C" int sosvo_match_hamming(const void* desc_a, const void* desc_b,
                                   const void* valid_a, const void* valid_b,
                                   const void* az_a, const void* az_b,
                                   int ka, int kb, float band,
                                   void* d_best, void* d_second, void* idx_b,
                                   void* col_key, void* stream) {
  if (ka <= 0 || kb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ka + kRowsPerBlock - 1) / kRowsPerBlock);
  match_hamming_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(desc_a), static_cast<const uint32_t*>(desc_b),
      static_cast<const bool*>(valid_a), static_cast<const bool*>(valid_b),
      static_cast<const float*>(az_a), static_cast<const float*>(az_b),
      ka, kb, band,
      static_cast<float*>(d_best), static_cast<float*>(d_second),
      static_cast<int*>(idx_b), static_cast<unsigned long long*>(col_key));
  return static_cast<int>(cudaGetLastError());
}
