// K1: per-pixel mean and max over the time axis of a (T, H, W) movie.
//
// Replaces the Pallas TPU kernel deepcalcium_tpu/ops/summary.py
// ::_summary_kernel, launched by movie_summary_pallas. Same contract: one
// pass over the movie, returning (sum / T, max) as two (H, W) float32
// images, for int16, uint16 or float32 input.
//
// Bound: device-memory bandwidth. The work is two operations per element
// read (2 per 2 bytes for int16), far below the card's ridge point, so the
// time is the movie's bytes over the bandwidth the loads reach.
//
// Design. The TPU kernel walks a sequential time grid with accumulators
// kept in VMEM; here blocks run in no order, so each thread owns pixels for
// the whole of T and keeps its sums and maxima in registers. A frame is one
// contiguous run of H*W pixels, and each thread owns N consecutive pixels of
// it (16 bytes: 8 int16/uint16 or 4 float32), loaded with one 16-byte load
// per frame; a vector may run on into the next row, which changes nothing
// for a per-pixel reduction. Neighbouring threads own neighbouring vectors,
// so a warp reads 512 contiguous bytes of each frame. The time loop is
// unrolled so that several frames' loads are in flight per thread. When the
// base pointer or the frame pitch (H*W*sizeof) is not 16-byte aligned, or
// for the H*W % N tail, threads fall back to one pixel each with scalar
// loads. All offsets are 64-bit: a 3000x512x512 float32 movie is 3.1 GB.
//
// Sums are exact for integer input: int32 accumulators (exact for up to
// 32768 frames of 16-bit values) are flushed into int64 totals every 32768
// frames. Float input accumulates in float64. The total is rounded to
// float32 once and divided by T with an IEEE division, so the result is the
// correctly rounded f32 sum over f32(T): bitwise what the plain PyTorch
// version in ops/summary.py computes, in any summation order.
//
// Occupancy is left for later: at 512x512 int16 there are 32768 vectors,
// one thread each, far fewer than the card holds resident. A split-T pass
// with a combine is the first optimisation to try.
//
// The streaming fold (dc_movie_fold) is the same reduction over frames
// [0, n_valid) of one chunk, added into running accumulators in device
// memory instead of finalised: int64 totals for int16/uint16, float64 for
// float32, and a float32 running max (exact for 16-bit values). It replaces
// the XLA updates _streaming_device_update(_mean) of
// deepcalcium_tpu/ops/summary.py. Frames at or past n_valid are never read,
// so a fixed-size staging buffer carries a ragged last chunk without
// padding. Finalised as K1 finalises (the total rounded to f32 once, then
// an IEEE division), a fold over any chunking gives K1's bits for integer
// movies. Its bound is the same: the chunk's bytes, plus 24 bytes a pixel
// of accumulators read and written, over the memory bandwidth.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kFlush = 32768;

template <typename T> struct Acc {
  using part = int;         // exact for kFlush frames of 16-bit values
  using total = long long;  // exact for any T that fits in memory
};
template <> struct Acc<float> {
  using part = double;
  using total = double;
};

template <typename T> __device__ __forceinline__ T lowest();
template <> __device__ __forceinline__ int16_t lowest<int16_t>() { return INT16_MIN; }
template <> __device__ __forceinline__ uint16_t lowest<uint16_t>() { return 0; }
template <> __device__ __forceinline__ float lowest<float>() { return -INFINITY; }

template <typename T> __device__ __forceinline__ T vmax(T a, T b) { return a > b ? a : b; }
template <> __device__ __forceinline__ float vmax<float>(float a, float b) { return fmaxf(a, b); }

__device__ __forceinline__ float round_f32(long long v) { return __ll2float_rn(v); }
__device__ __forceinline__ float round_f32(double v) { return __double2float_rn(v); }

// N consecutive elements at src: one 16-byte load when N * sizeof(T) == 16
// (src then 16-byte aligned), else N scalar loads.
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ src, T (&out)[N]) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    memcpy(out, &raw, 16);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = __ldg(src + k);
  }
}

// Reduce pixels [p, p + N) over frames [0, t_len): exact totals and maxima.
template <typename T, int N>
__device__ __forceinline__ void reduce_pixels(
    const T* __restrict__ movie, long long t_len, long long hw, long long p,
    typename Acc<T>::total (&total)[N], T (&m)[N]) {
  using Part = typename Acc<T>::part;
  using Total = typename Acc<T>::total;
  Part part[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    total[k] = 0;
    part[k] = 0;
    m[k] = lowest<T>();
  }
  const T* src = movie + p;
  long long t = 0;
  while (t < t_len) {
    const long long stop = t_len < t + kFlush ? t_len : t + kFlush;
    for (; t + kUnroll <= stop; t += kUnroll) {
      T x[kUnroll][N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load<T, N>(src + (t + u) * hw, x[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          part[k] += static_cast<Part>(x[u][k]);
          m[k] = vmax(m[k], x[u][k]);
        }
      }
    }
    for (; t < stop; ++t) {
      T x[N];
      load<T, N>(src + t * hw, x);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        part[k] += static_cast<Part>(x[k]);
        m[k] = vmax(m[k], x[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      total[k] += static_cast<Total>(part[k]);
      part[k] = 0;
    }
  }
}

// K1's epilogue: write mean = f32(total) / f32(t_len) and max.
struct Finalise {
  float* mean;
  float* mx;
  long long t_len;
  template <typename T, typename Total, int N>
  __device__ __forceinline__ void operator()(long long p, const Total (&total)[N],
                                             const T (&m)[N]) const {
    const float tf = static_cast<float>(t_len);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      mean[p + k] = __fdiv_rn(round_f32(total[k]), tf);
      mx[p + k] = static_cast<float>(m[k]);
    }
  }
};

// The fold's epilogue: add into the running totals and, unless mx is null,
// raise the running max.
template <typename Total>
struct Accumulate {
  Total* acc;
  float* mx;
  template <typename T, int N>
  __device__ __forceinline__ void operator()(long long p, const Total (&total)[N],
                                             const T (&m)[N]) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      acc[p + k] += total[k];
      if (mx != nullptr) mx[p + k] = fmaxf(mx[p + k], static_cast<float>(m[k]));
    }
  }
};

template <typename T, int N, typename Epilogue>
__device__ __forceinline__ void reduce_and_store(const T* __restrict__ movie,
                                                 long long t_len, long long hw,
                                                 long long p,
                                                 const Epilogue& out) {
  typename Acc<T>::total total[N];
  T m[N];
  reduce_pixels<T, N>(movie, t_len, hw, p, total, m);
  out(p, total, m);
}

// Threads [0, nvec) own one 16-byte vector each; the threads after them
// own one pixel each of the remaining hw - nvec * N.
template <typename T, typename Epilogue>
__global__ void __launch_bounds__(kThreads)
summary_kernel(const T* __restrict__ movie, long long t_len, long long hw,
               long long nvec, Epilogue out) {
  constexpr int N = 16 / sizeof(T);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < nvec) {
    reduce_and_store<T, N>(movie, t_len, hw, i * N, out);
  } else {
    const long long p = nvec * N + (i - nvec);
    if (p < hw) reduce_and_store<T, 1>(movie, t_len, hw, p, out);
  }
}

template <typename T, typename Epilogue>
cudaError_t launch(const void* movie, long long t_len, long long hw,
                   const Epilogue& out, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(movie) % 16 == 0 &&
                       (hw * static_cast<long long>(sizeof(T))) % 16 == 0;
  const long long nvec = aligned ? hw / N : 0;
  const long long nthreads = nvec + (hw - nvec * N);
  const long long blocks = (nthreads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  summary_kernel<T, Epilogue><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(movie), t_len, hw, nvec, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_summary(const void* movie, long long t_len, long long hw,
                           float* mean, float* mx, cudaStream_t stream) {
  return launch<T>(movie, t_len, hw, Finalise{mean, mx, t_len}, stream);
}

template <typename T>
cudaError_t launch_fold(const void* chunk, long long n_valid, long long hw,
                        void* total, float* mx, cudaStream_t stream) {
  using Total = typename Acc<T>::total;
  return launch<T>(chunk, n_valid, hw,
                   Accumulate<Total>{static_cast<Total*>(total), mx}, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = int16, 1 = uint16, 2 = float32. movie is a contiguous
// (t_len, hw) device array; mean and mx are hw float32 each. Launches on
// stream and returns the launch's cudaError_t (0 on success).
int dc_movie_summary(const void* movie, int dtype, long long t_len,
                     long long hw, float* mean, float* mx, void* stream) {
  if (t_len <= 0 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_summary<int16_t>(movie, t_len, hw, mean, mx, s));
    case 1: return static_cast<int>(launch_summary<uint16_t>(movie, t_len, hw, mean, mx, s));
    case 2: return static_cast<int>(launch_summary<float>(movie, t_len, hw, mean, mx, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Fold frames [0, n_valid) of a contiguous (>= n_valid, hw) device chunk
// into total (hw int64 for dtypes 0 and 1, hw float64 for dtype 2) and, when
// mx is not null, into the hw float32 running max. Frames from n_valid on
// are not read. Launches on stream; returns the launch's cudaError_t.
int dc_movie_fold(const void* chunk, int dtype, long long n_valid,
                  long long hw, void* total, float* mx, void* stream) {
  if (n_valid <= 0 || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_fold<int16_t>(chunk, n_valid, hw, total, mx, s));
    case 1: return static_cast<int>(launch_fold<uint16_t>(chunk, n_valid, hw, total, mx, s));
    case 2: return static_cast<int>(launch_fold<float>(chunk, n_valid, hw, total, mx, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* dc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
