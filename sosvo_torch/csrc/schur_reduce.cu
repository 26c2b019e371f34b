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
// operations, with no contraction into FMAs.
//
// Design (Hopper, sm_90a): the TPU kernel carried S_off across sequential
// grid steps in VMEM, and packed H_cl into three padded (L, 6W) component
// planes for Mosaic's (8, 128) tiling. Blocks here run in no order, so:
//   * H_cl is read in its own (W, L, 6, 3) layout through the W and L
//     strides the wrapper passes (the trailing 6 x 3 must be contiguous);
//     the ragged edge of L is masked in the kernel, nothing is padded;
//   * pass 1: one block per tile of kTileL landmarks. The tile's coupling
//     blocks go to shared memory; one thread per landmark forms the damped
//     inverse and writes it out; the block forms its A; then every thread
//     owns entries of the tile's (6W)^2 + 6W partial sums (over the tile's
//     landmarks and k) and writes them to a scratch row of its own;
//   * pass 2: one thread per entry sums the blocks' rows in block order and
//     assembles S_off, S, b_sub, b_red.
// No atomics: the sums are taken in a fixed order, so two calls on the same
// inputs give bit-identical outputs (LM's accept test `cand_cost < cost`
// would otherwise flip between runs of one tree).
//
// Bound on the card, worked out for W = 5, L = 512 (the c2 window): the
// function reads H_cl (W*L*18 floats), H_ll, b_l, H_cc, b_c once and writes
// the contract's H_ll_inv, S, b_red once: about 0.23 MB, 0.069 us at
// 3.35 TB/s; it needs about 3.6 kFLOP per landmark (3 n (n + 1) with
// n = 6W for the symmetric S_off, 108 W for A, 36 W for b_sub, ~40 for the
// inverse), 1.8 MFLOP, 0.027 us at the 67 TFLOP/s of f32 outside the
// tensor cores (sosvo_torch/tools/bounds.py). Two launches of a few
// microseconds each dwarf both: the kernel is launch-latency bound, and
// tensor cores, TMA or a single persistent pass would not change that at
// these sizes.
//
// Built by sosvo_torch/kernels/build.py with nvcc into the package's shared
// library with a plain C interface.

#include <cuda_runtime.h>

namespace {

constexpr int kTileL = 32;    // landmarks per block in pass 1
constexpr int kThreads = 256;
constexpr int kFinalizeThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
schur_partial_kernel(const float* __restrict__ H_cl, long long stride_w, long long stride_l,
                     const float* __restrict__ H_ll, const float* __restrict__ b_l,
                     const float* __restrict__ lam_ptr, int W, int L,
                     float* __restrict__ H_ll_inv, float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int n = 6 * W;        // rows of the camera system
  const int per_lm = 3 * n;   // floats of one landmark's coupling column
  float* sH = smem;                    // [kTileL][n][3]
  float* sA = sH + kTileL * per_lm;    // [kTileL][n][3]
  float* sInv = sA + kTileL * per_lm;  // [kTileL][9]
  float* sB = sInv + kTileL * 9;       // [kTileL][3]
  const int l0 = blockIdx.x * kTileL;
  const int tid = threadIdx.x;

  // The tile's coupling blocks, keyframe by keyframe: for one w the tile's
  // landmarks are consecutive in memory (18 floats each).
  for (int idx = tid; idx < W * kTileL * 18; idx += kThreads) {
    const int w = idx / (kTileL * 18);
    const int rem = idx - w * (kTileL * 18);
    const int t = rem / 18;
    const int q = rem - t * 18;
    const int l = l0 + t;
    sH[t * per_lm + w * 18 + q] = (l < L) ? H_cl[w * stride_w + l * stride_l + q] : 0.0f;
  }
  if (tid < kTileL) {
    const int l = l0 + tid;
    float inv[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float bl[3] = {0.f, 0.f, 0.f};
    if (l < L) {
      float h[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) h[k] = H_ll[9LL * l + k];
      inv9(h, *lam_ptr, inv);
#pragma unroll
      for (int k = 0; k < 9; ++k) H_ll_inv[9LL * l + k] = inv[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) bl[k] = b_l[3LL * l + k];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) sInv[tid * 9 + k] = inv[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) sB[tid * 3 + k] = bl[k];
  }
  __syncthreads();

  // A[t, r, :] = H[t, r, :] @ inv[t]   (r = 6 w + i)
  for (int idx = tid; idx < kTileL * n; idx += kThreads) {
    const int t = idx / n;
    const float* h = sH + 3 * idx;
    const float* iv = sInv + 9 * t;
#pragma unroll
    for (int k = 0; k < 3; ++k) sA[3 * idx + k] = h[0] * iv[k] + h[1] * iv[3 + k] + h[2] * iv[6 + k];
  }
  __syncthreads();

  // The tile's partial sums: S_off[r, c] = sum_t,k A[t,r,k] H[t,c,k] in
  // entries [0, n^2) (row-major), b_sub[r] = sum_t,k A[t,r,k] b[t,k] after.
  const int n2 = n * n;
  float* out = partial + static_cast<long long>(blockIdx.x) * (n2 + n);
  for (int e = tid; e < n2 + n; e += kThreads) {
    float s = 0.0f;
    if (e < n2) {
      const int r = e / n;
      const int c = e - r * n;
      for (int t = 0; t < kTileL; ++t) {
        const float* a = sA + 3 * (t * n + r);
        const float* h = sH + 3 * (t * n + c);
        s += a[0] * h[0] + a[1] * h[1] + a[2] * h[2];
      }
    } else {
      const int r = e - n2;
      for (int t = 0; t < kTileL; ++t) {
        const float* a = sA + 3 * (t * n + r);
        const float* b = sB + 3 * t;
        s += a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
      }
    }
    out[e] = s;
  }
}

__global__ void __launch_bounds__(kFinalizeThreads)
schur_finalize_kernel(const float* __restrict__ partial, int n_blocks, int W,
                      const float* __restrict__ H_cc, const float* __restrict__ b_c,
                      const float* __restrict__ lam_ptr, int damp_H_cc,
                      float* __restrict__ S_off, float* __restrict__ b_sub,
                      float* __restrict__ S, float* __restrict__ b_red) {
  const int n = 6 * W;
  const int n2 = n * n;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n2 + n) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partial[static_cast<long long>(b) * (n2 + n) + e];
  if (e < n2) {
    const int r = e / n;
    const int c = e - r * n;
    const int w = r / 6, i = r - 6 * (r / 6);
    const int v = c / 6, j = c - 6 * (c / 6);
    const int o = ((w * W + v) * 6 + i) * 6 + j;  // (W, W, 6, 6) block layout
    float diag = 0.0f;
    if (w == v) {
      diag = H_cc[(w * 6 + i) * 6 + j];
      if (damp_H_cc && i == j) diag += *lam_ptr;
    }
    S_off[o] = s;
    S[o] = diag - s;
  } else {
    const int r = e - n2;
    b_sub[r] = s;
    b_red[r] = b_c[r] - s;
  }
}

}  // namespace

// Landmarks per pass-1 block: the wrapper sizes `partial` as
// ceil(L / tile) * ((6W)^2 + 6W) floats.
extern "C" int sosvo_schur_tile_l() { return kTileL; }

// Launches both passes on `stream`; returns the launch status
// (cudaGetLastError) as an int, 0 on success. `lam` is a device pointer to
// one float, so an LM loop on the card never reads it back. Strides are in
// floats.
extern "C" int sosvo_schur_reduce(const void* H_cl, long long stride_w, long long stride_l,
                                  const void* H_ll, const void* b_l, const void* H_cc,
                                  const void* b_c, const void* lam, int W, int L, int damp_H_cc,
                                  void* partial, void* H_ll_inv, void* S_off, void* b_sub,
                                  void* S, void* b_red, void* stream) {
  if (W <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = 6 * W;
  const size_t smem = (2 * kTileL * 3 * n + kTileL * 12) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        schur_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (L + kTileL - 1) / kTileL;
  schur_partial_kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const float*>(H_cl), stride_w, stride_l, static_cast<const float*>(H_ll),
      static_cast<const float*>(b_l), static_cast<const float*>(lam), W, L,
      static_cast<float*>(H_ll_inv), static_cast<float*>(partial));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n * n + n;
  schur_finalize_kernel<<<(total + kFinalizeThreads - 1) / kFinalizeThreads, kFinalizeThreads, 0,
                          st>>>(
      static_cast<const float*>(partial), blocks, W, static_cast<const float*>(H_cc),
      static_cast<const float*>(b_c), static_cast<const float*>(lam), damp_H_cc,
      static_cast<float*>(S_off), static_cast<float*>(b_sub), static_cast<float*>(S),
      static_cast<float*>(b_red));
  return static_cast<int>(cudaGetLastError());
}
