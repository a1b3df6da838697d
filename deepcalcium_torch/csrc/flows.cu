// Cellpose's flow dynamics: the two step loops of ops/flows.py, each run
// inside one launch that loops on the card.
//
// These replace no TPU kernel: the JAX package has no Cellpose. They exist
// because both loops were bound by launches. Each Euler step was a few tiny
// kernels (grid_sample, then a permute, an add and a clamp), and so was each
// step of the flow check's diffusion (index_add_, a gather, cumsum and a
// divide): about 280 steps a call, each replayed from a one-step CUDA graph,
// each taking the card tens of microseconds for a few microseconds of work.
//
// dc_euler_steps, the Euler steps of follow_flows. One thread a followed
// pixel normalises its (y, x) as the plain version does and holds the
// normalised (x, y) in registers for all niter steps. A step is
// grid_sample's bilinear read (zero padding, align_corners=False) of the
// two channels of the field, then the add and the clamp to [-1, 1]; after
// the last step the position becomes integer (y, x) as the plain version
// makes it. The arithmetic is PyTorch's grid_sampler_2d CUDA kernel's, in its
// order and with its rounding written out as explicit intrinsics, so the end
// points are bitwise the plain version's on the card. Bound: a step's reads
// depend on the last step's position, so one thread's niter steps are niter
// round trips to the 2 MB field, which stays in the 50 MB L2: niter times
// the L2 hit latency, some tens of microseconds for 200 steps whatever the
// number of pixels (the cell's ~28,400 pixels are one wave of 128-thread
// blocks). The design does nothing between the round trips but the step's
// arithmetic: the eight reads of a step are issued together, and no
// position leaves the registers until the end.
//
// dc_diffuse, the float64 diffusion of the flow check (masks_to_flows). One
// block a mask walks that mask's pixels; the wrapper has grouped the pixels
// by label on the card and given each pixel's 9 neighbours as indices local
// to its mask (-1 for a neighbour outside it). T is double-buffered: in the
// block's dynamic shared memory where the mask fits, in a global scratch
// buffer where it does not (a mask may cover 40% of the image); both
// branches run the same code on another pointer. A step reads the mask's
// centre plus 1, sums each pixel's 9 neighbours one after another in
// Cellpose's order and multiplies by the float64 reciprocal of 9 (which is
// what PyTorch's CUDA division by a scalar computes), reading only the
// previous buffer, so T is bitwise the plain version's. Masks never read
// each other's pixels, so no grid-wide barrier is needed. Bound: the steps
// are dependent rounds, each a __syncthreads, a shared-memory read and nine
// dependent float64 adds: well under a microsecond a step, a few tens of
// microseconds for the cell's ~80 steps, with every mask's block resident at
// once. The design keeps each round to one barrier (the centre's +1 is added
// where it is read, so no barrier separates it from the sum) and keeps T out
// of device memory wherever shared memory holds the mask.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kEulerThreads = 128;
constexpr int kDiffuseMaxThreads = 1024;

// grid_sample's source index at align_corners=False, ((coord + 1) * size -
// 1) / 2 as ATen/native/cuda/GridSampler.cuh writes it; PyTorch's compiled
// kernel contracts the product and the subtraction into one fma, and the
// division by 2 is exact.
__device__ __forceinline__ float source_index(float coord, float size) {
  return __fmul_rn(__fmaf_rn(__fadd_rn(coord, 1.f), size, -1.f), 0.5f);
}

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

// One channel of grid_sample's bilinear read: the corners nw, ne, sw, se in
// that order, each only where it lies in the image, each accumulated as the
// compiled kernel's out_acc += value * weight (one fma).
__device__ __forceinline__ float bilinear(const float* __restrict__ ch, int h,
                                          int w, int x0, int y0, float nw,
                                          float ne, float sw, float se) {
  float acc = 0.f;
  if (inside(y0, x0, h, w)) acc = __fmaf_rn(__ldg(ch + y0 * w + x0), nw, acc);
  if (inside(y0, x0 + 1, h, w)) acc = __fmaf_rn(__ldg(ch + y0 * w + x0 + 1), ne, acc);
  if (inside(y0 + 1, x0, h, w)) acc = __fmaf_rn(__ldg(ch + (y0 + 1) * w + x0), sw, acc);
  if (inside(y0 + 1, x0 + 1, h, w)) acc = __fmaf_rn(__ldg(ch + (y0 + 1) * w + x0 + 1), se, acc);
  return acc;
}

__device__ __forceinline__ float clamp1(float v) {
  return fminf(fmaxf(v, -1.f), 1.f);
}

// A pixel index normalised to [-1, 1] as the plain version does it:
// float(p) / (L - 1) * 2 - 1, PyTorch dividing by a scalar through its
// float reciprocal.
__device__ __forceinline__ float normalise(long long p, float inv) {
  return __fsub_rn(__fmul_rn(__fmul_rn(static_cast<float>(p), inv), 2.f), 1.f);
}

// Pixel i (inds: (y, x) int64) moves niter steps through the field im
// (2, h, w): channel 0 moves x, channel 1 moves y. Writes (y, x) int64.
__global__ void __launch_bounds__(kEulerThreads)
euler_kernel(const float* __restrict__ im, int h, int w,
             const long long* __restrict__ inds, long long n, int niter,
             long long* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kEulerThreads + threadIdx.x;
  if (i >= n) return;
  const float* __restrict__ fx = im;
  const float* __restrict__ fy = im + static_cast<long long>(h) * w;
  const float hf = static_cast<float>(h), wf = static_cast<float>(w);
  float x = normalise(inds[2 * i + 1], __fdiv_rn(1.f, wf - 1.f));
  float y = normalise(inds[2 * i], __fdiv_rn(1.f, hf - 1.f));
  for (int s = 0; s < niter; ++s) {
    const float ix = source_index(x, wf), iy = source_index(y, hf);
    const int x0 = static_cast<int>(floorf(ix)), y0 = static_cast<int>(floorf(iy));
    const float x1 = static_cast<float>(x0 + 1), y1 = static_cast<float>(y0 + 1);
    const float ax = __fsub_rn(ix, static_cast<float>(x0));
    const float ay = __fsub_rn(iy, static_cast<float>(y0));
    const float bx = __fsub_rn(x1, ix), by = __fsub_rn(y1, iy);
    // grid_sampler_2d's surfaces: nw = (ix_se - ix) * (iy_se - iy),
    // ne = (ix - ix_sw) * (iy_sw - iy), sw = (ix_ne - ix) * (iy - iy_ne),
    // se = (ix - ix_nw) * (iy - iy_nw).
    const float nw = __fmul_rn(bx, by), ne = __fmul_rn(ax, by);
    const float sw = __fmul_rn(bx, ay), se = __fmul_rn(ax, ay);
    const float dx = bilinear(fx, h, w, x0, y0, nw, ne, sw, se);
    const float dy = bilinear(fy, h, w, x0, y0, nw, ne, sw, se);
    x = clamp1(__fadd_rn(x, dx));
    y = clamp1(__fadd_rn(y, dy));
  }
  // (p + 1) * 0.5 * (L - 1), truncated, as three of PyTorch's kernels do it.
  out[2 * i] = static_cast<long long>(
      __fmul_rn(__fmul_rn(__fadd_rn(y, 1.f), 0.5f), hf - 1.f));
  out[2 * i + 1] = static_cast<long long>(
      __fmul_rn(__fmul_rn(__fadd_rn(x, 1.f), 0.5f), wf - 1.f));
}

// Block m diffuses mask m: pixels [starts[m], starts[m + 1]) of the grouped
// order, whose neighbours nbl (9 a pixel) are local to the mask, -1 outside.
// T lives in shared memory when the mask has at most smem_px pixels, else in
// its own 2 * len slice of scratch. Writes the last step's T to out.
__global__ void __launch_bounds__(kDiffuseMaxThreads)
diffuse_kernel(const int* __restrict__ nbl, const int* __restrict__ starts,
               const int* __restrict__ centre, int steps, int smem_px,
               double* __restrict__ scratch, double* __restrict__ out) {
  extern __shared__ double shared_t[];
  const int m = blockIdx.x;
  const long long s0 = starts[m];
  const int len = starts[m + 1] - static_cast<int>(s0);
  if (len == 0) return;  // a label with no pixel: the whole block leaves
  double* a = len <= smem_px ? shared_t : scratch + 2 * s0;
  double* b = a + len;
  const int c = centre[m];
  const int* __restrict__ nb = nbl + 9 * s0;
  const double inv9 = 1.0 / 9.0;
  for (int i = threadIdx.x; i < len; i += blockDim.x) a[i] = 0.0;
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      double acc = 0.0;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int j = __ldg(nb + 9 * i + k);
        if (j >= 0) acc = __dadd_rn(acc, j == c ? __dadd_rn(a[j], 1.0) : a[j]);
      }
      b[i] = __dmul_rn(acc, inv9);
    }
    __syncthreads();
    double* t = a;
    a = b;
    b = t;
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) out[s0 + i] = a[i];
}

}  // namespace

extern "C" {

// im: (2, h, w) float32, channel 0 the x step and channel 1 the y step, in
// grid_sample's normalised units; inds: (n, 2) int64 pixels (y, x); out:
// (n, 2) int64 end points (y, x). All contiguous on the current device.
// Launches on stream; returns the launch's cudaError_t (0 on success).
int dc_euler_steps(const float* im, int h, int w, const long long* inds,
                   long long n, int niter, long long* out, void* stream) {
  if (h <= 1 || w <= 1 || n <= 0 || niter < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kEulerThreads - 1) / kEulerThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  euler_kernel<<<static_cast<unsigned>(blocks), kEulerThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(im, h, w, inds, n, niter, out);
  return static_cast<int>(cudaGetLastError());
}

// nbl: (P, 9) int32 neighbours local to their mask (-1 outside), the pixels
// grouped by mask; starts: (n_masks + 1) int32 offsets of the groups;
// centre: (n_masks) int32 local index of each mask's centre (-1: none);
// max_len: the largest group; scratch: 2 * P float64; out: P float64, T
// after steps steps in the grouped order. Launches on stream; returns the
// launch's cudaError_t (0 on success).
int dc_diffuse(const int* nbl, const int* starts, const int* centre,
               int n_masks, int max_len, int steps, double* scratch,
               double* out, void* stream) {
  if (n_masks <= 0 || max_len <= 0 || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cap_px = optin / static_cast<int>(2 * sizeof(double));
  const int smem_px = max_len < cap_px ? max_len : cap_px;
  const size_t smem = static_cast<size_t>(smem_px) * 2 * sizeof(double);
  err = cudaFuncSetAttribute(diffuse_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (max_len + 31) / 32 * 32;
  if (threads > kDiffuseMaxThreads) threads = kDiffuseMaxThreads;
  diffuse_kernel<<<n_masks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      nbl, starts, centre, steps, smem_px, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
