// Cellpose-SAM's attention: softmax(q k^T / sqrt(d) + B) v over every token
// of a (gh, gw) grid, with SAM's decomposed relative-position bias
//
//     B[(i, j), (k, l)] = q_ij . Rh[i - k + gh - 1] + q_ij . Rw[j - l + gw - 1]
//
// (ops/attention.py states it and holds the plain version). The kernels read
// q, k and v of one head straight from the qkv projection's (B, N, 3 heads d)
// output and write (B, N, heads d), the layout the output projection reads.
//
// They replace no TPU kernel: the JAX package has no Cellpose. The bf16
// kernel replaces the padded flash-attention call of the plain version and
// its copies (the bias folded into a head dim of d + gh + gw, q scaled, the
// cats and pads, the output's transpose). Bound: the tensor cores' bf16 rate
// on QK^T and PV, 4 N^2 d FLOPs a head, plus the bias's 2 N (2 gh + 2 gw) d;
// the qkv it reads and the output it writes take about half that time at the
// HBM's rate.
//
// dc_rel_pos_attention, bfloat16 (attention_bf16_kernel). A block is one
// warpgroup (4 warps, 16 queries each) and takes one (batch, head) pair and
// 64 consecutive query tokens, whose q stays in registers for the whole
// block as the A operand of Hopper's wgmma (m64n64k16, bf16 into float32; B
// from shared memory in 128-byte-swizzled panels of 64 columns). Before the
// key loop the block multiplies its queries by every row of both tables
// (F_h = q Rh^T, F_w = q Rw^T) and keeps F_h in shared memory and, from F_w,
// each of a thread's score positions' rel_w entry in registers. A step
// covers 64 key slots: 64 / GWP whole grid rows of GWP columns (gw padded to
// a power of two), so a slot's grid column, and with it its rel_w term, is
// the same at every step; its rel_h term is F_h[m, i - k + gh - 1], one
// shared-memory read a query and grid row. The K and V tiles of a step are
// boxes of a 5-D tensor map of the qkv output, copied by the TMA into a
// double buffer (one thread starts them; zeros past the grid's edges), and
// each block starts its walk over them at its own tile. S = q K^T reads K as
// a K-major B and O += P V reads V as an MN-major B, both from the same
// layout. The scores take the bias in float32 and an online softmax in
// base 2 (scale and bias premultiplied by log2 e); the probabilities enter
// PV as bf16 A fragments straight from S's accumulators, as flash attention
// does. Slots outside the grid take a bias of -inf. Nothing but q, k, v, the
// tables and the output touches device memory. (Copies by cp.async from
// every thread took the card twice as long at the Cellpose shapes, and a
// layout of 8-row core matrices, which scatters each row's 16-byte pieces,
// three times as long; PERF.md gives the times.)
//
// The same entry takes float32 (attention_f32_kernel): one thread a query,
// float32 products on the CUDA cores in the same formula, for the float32
// compute the command line runs by default. It is no path any cell measures.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // one warpgroup: 4 warps, 16 queries each
constexpr int kBM = 64;            // queries a block
constexpr int kBN = 64;            // key slots a step
constexpr int kStages = 2;         // K and V tiles in shared memory
constexpr int kF32Threads = 64;    // queries a float32 block
constexpr int kF32Keys = 16;       // keys a float32 step
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = uint16_t;             // a bfloat16's bits

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where src_bytes is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// An mbarrier in shared memory: init with one arrival a phase, the arrival
// that also expects bytes of copies, and the wait for a phase's parity.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bar)));
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// A box of the 5-D tensor map into shared memory by the TMA, completing on
// bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, int c3, int c4,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory written by threads, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Element (row, chunk) of a tile of R rows and D columns, chunk a 16-byte
// piece of a row: panels of 64 columns, each row-major in 128-byte rows
// whose chunks are permuted by the row's low three bits (Hopper's 128-byte
// swizzle; a panel must start on 1024 bytes). A row's 16-byte pieces stay
// together, so its copy from device memory lands whole; wgmma reads the
// panels without bank conflicts.
__device__ __forceinline__ int swizzled(int rows, int row, int chunk) {
  return (chunk >> 3) * rows * 64 + row * 64 + (((chunk & 7) ^ (row & 7)) << 3);
}

// A wgmma descriptor of B at p in a 128-byte-swizzled panel: groups of 8
// rows 1024 bytes apart, one swizzle atom across (64 columns).
__device__ __forceinline__ uint64_t descriptor(const bf16* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(1) << 16
         | static_cast<uint64_t>(1024 >> 4) << 32
         | static_cast<uint64_t>(1) << 62;
}

// d (64 x 64 float32, the warpgroup's) += a (64 x 16 bf16, registers) b (16
// x 64 bf16 at desc; K-major, or MN-major where TransB), or = a b where
// accumulate is 0.
template <int TransB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate),
        "n"(TransB));
}

// Two floats as bf16, rounded to nearest even: lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t load_pair(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

inline int pad64(int v) { return (v + 63) / 64 * 64; }

// Shared memory of the bf16 kernel, from a 1024-byte boundary: first the
// tables (bf16 panels) and F_w (float32) before the key loop, and the K and
// V tiles of kStages steps in the same space during it; then F_h (float32).
// Rows of F are one longer than the table, so that reads of F_h do not
// conflict.
template <int D>
__host__ __device__ constexpr int front_bytes(int th_rows, int tw_rows) {
  const int before = (th_rows + tw_rows) * D * 2 + kBM * (tw_rows + 1) * 4;
  const int during = kStages * 2 * kBN * D * 2;
  return before > during ? before : during;
}

// Block (x, y): query tokens [kBM x, kBM x + kBM) of (batch, head) pair y.
// D is the head dim padded to 64 or 128 (the columns past d are zeros);
// sh = log2(GWP); th_rows, tw_rows: the tables' lengths padded to 64.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 1)
attention_bf16_kernel(const __grid_constant__ CUtensorMap kv_map,
                      const bf16* __restrict__ qkv, const bf16* __restrict__ th,
                      const bf16* __restrict__ tw, bf16* __restrict__ out,
                      int gh, int gw, int heads, int d, int sh, int th_rows,
                      int tw_rows, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  constexpr int KC = D / 16;          // 16-wide chunks of the head dim
  constexpr int CH = D / 8;           // 16-byte chunks of a row
  constexpr int TILE = kBN * D;       // elements of a tile
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  const int fs = th_rows + 1, fws = tw_rows + 1;
  float* fh = reinterpret_cast<float*>(smem + front_bytes<D>(th_rows, tw_rows));
  float* fw = reinterpret_cast<float*>(smem + (th_rows + tw_rows) * D * 2);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + ((front_bytes<D>(th_rows, tw_rows) + kBM * fs * 4 + 7) & ~7));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) bar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int n = gh * gw, hd = heads * d;
  const int pair = blockIdx.y, b = pair / heads, h = pair - b * heads;
  const long long row = 3LL * hd;     // elements of a token's qkv
  const bf16* q_base = qkv + static_cast<long long>(b) * n * row + h * d;

  // The tables into the tile space, zero rows and columns past their ends.
  bf16* const tw_tile = tiles + th_rows * D;
  for (int idx = tid; idx < (th_rows + tw_rows) * CH; idx += kThreads) {
    const int r = idx / CH, cc = idx - r * CH;
    const bool is_h = r < th_rows;
    const int t = is_h ? r : r - th_rows;
    const bool ok = t < (is_h ? 2 * gh - 1 : 2 * gw - 1) && 8 * cc < d;
    const bf16* src = (is_h ? th : tw) + (ok ? t * d + 8 * cc : 0);
    cp_async16((is_h ? tiles : tw_tile) + swizzled(is_h ? th_rows : tw_rows, t, cc),
               src, ok ? 16 : 0);
  }
  cp_async_commit();

  // The warp's queries as A fragments: rows m0 = 16 warp + g and m0 + 8.
  const int m0 = 16 * warp + g;
  int tok[2], qi[2], qj[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tok[r] = kBM * blockIdx.x + m0 + 8 * r;
    const int t = tok[r] < n ? tok[r] : 0;
    qi[r] = t / gw;
    qj[r] = t - qi[r] * gw;
  }
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const bool in_d = 16 * kc < d;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = in_d && tok[r] < n;
      const bf16* p = q_base + tok[r] * row + 16 * kc + 2 * c;
      qf[kc][r] = load_pair(p, ok);
      qf[kc][2 + r] = load_pair(p + 8, ok);
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // F_h and F_w, 64 table rows at a time: accumulator entry 4 i + k of the
  // thread is row m0 + 8 (k / 2), column 8 i + 2 c + k % 2.
  for (int j = 0; j < (th_rows + tw_rows) / 64; ++j) {
    const bool is_h = 64 * j < th_rows;
    const int rows = is_h ? th_rows : tw_rows, r0 = is_h ? 64 * j : 64 * j - th_rows;
    const bf16* t = (is_h ? tiles : tw_tile) + r0 * 64;
    float acc[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      wgmma_n64<0>(acc, qf[kc], descriptor(t + (kc >> 2) * rows * 64 + (kc & 3) * 16),
                   kc);
    wgmma_commit_and_wait();
    float* f = (is_h ? fh : fw) + r0;
    const int stride = is_h ? fs : fws;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        f[(m0 + 8 * (k >> 1)) * stride + 8 * i + 2 * c + (k & 1)] =
            acc[4 * i + k] * kLog2e;
  }
  __syncthreads();

  const int gwp = 1 << sh, rps = kBN >> sh;   // grid rows a step
  const int steps = (gh + rps - 1) / rps;
  // Each block walks the key tiles from its own first tile: the blocks of
  // one (batch, head) pair run together, and would otherwise all read the
  // same lines of L2 at once.
  const int first = blockIdx.x % steps;
  auto tile_of = [&](int step) {
    const int t = step + first;
    return t < steps ? t : t - steps;
  };
  // K and V of a key tile into buffer buf, one box a 64-column panel: slot
  // kr x GWP + l of the box is the key (tile rps + kr, l), zeros past the
  // grid's edges. Thread 0 starts it.
  auto load_kv = [&](int tile, int buf) {
    bar_expect(bars + buf, 2 * TILE * static_cast<int>(sizeof(bf16)));
#pragma unroll
    for (int which = 0; which < 2; ++which)
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        tma_load(tiles + (2 * buf + which) * TILE + p * kBN * 64, &kv_map, 64 * p,
                 (1 + which) * heads + h, 0, tile * rps, b, bars + buf);
  };
  // rel_w of each of the thread's score positions, (row m0 + 8 r, slot 8 i
  // + 2 c + e) at w[i][2 r + e], the layout of the scores; -inf in the
  // padded columns.
  float w[8][4];
  const float* fh_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + 8 * r;
    fh_row[r] = fh + m * fs + qi[r] + gh - 1;   // minus the key's grid row
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int l = (8 * i + 2 * c + e) & (gwp - 1);
        w[i][2 * r + e] = l < gw ? fw[m * fws + qj[r] - l + gw - 1] : -INFINITY;
      }
    }
  }
  __syncthreads();                    // the tables and F_w are read
  if (tid == 0) {
    fence_proxy_async();              // before the TMA writes over them
    for (int t = 0; t < kStages - 1 && t < steps; ++t) load_kv(tile_of(t), t);
  }

  float o[D / 64][32] = {};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int step = 0; step < steps; ++step) {
    // The step's tile has landed, and every thread is past the last step,
    // whose buffer takes the tile kStages - 1 steps ahead.
    bar_wait(bars + step % kStages, (step / kStages) & 1);
    __syncthreads();
    const int ahead = step + kStages - 1;
    if (tid == 0 && ahead < steps) load_kv(tile_of(ahead), ahead % kStages);
    const bf16* ks = tiles + 2 * (step % kStages) * TILE;
    const bf16* vs = ks + TILE;

    float s[32] = {};
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      wgmma_n64<0>(s, qf[kc], descriptor(ks + (kc >> 2) * kBN * 64 + (kc & 3) * 16),
                   kc);
    wgmma_commit_and_wait();

    // Scale and bias, then the running maxima of the thread's two rows. A
    // slot's grid row is step rps + slot / GWP; with GWP >= 8 a thread's
    // two slots 8 i + 2 c + {0, 1} lie in one grid row.
    const int kr0 = tile_of(step) * rps;
    const bool full = kr0 + rps <= gh;
    auto bias_h = [&](int r, int kr) {
      return full || kr < gh ? fh_row[r][-kr] : -INFINITY;
    };
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float h0 = bias_h(r, kr0 + ((8 * i + 2 * c) >> sh));
        const float h1 = sh >= 3 ? h0 : bias_h(r, kr0 + ((8 * i + 2 * c + 1) >> sh));
        float& v0 = s[4 * i + 2 * r];
        float& v1 = s[4 * i + 2 * r + 1];
        v0 = fmaf(v0, scale, h0 + w[i][2 * r]);
        v1 = fmaf(v1, scale, h1 + w[i][2 * r + 1]);
        mx[r] = fmaxf(mx[r], fmaxf(v0, v1));
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      s[k] = ex2(s[k] - m_run[(k >> 1) & 1]);
      l_run[(k >> 1) & 1] += s[k];
    }
#pragma unroll
    for (int j = 0; j < D / 64; ++j)
#pragma unroll
      for (int k = 0; k < 32; ++k) o[j][k] *= alpha[(k >> 1) & 1];

    // O += P V: the scores of key columns 16 kc to 16 kc + 15 are the A
    // fragment of key chunk kc; V is read a panel (64 dims) at a time.
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        pa[kc][k] = pack_bf16(s[8 * kc + 2 * k], s[8 * kc + 2 * k + 1]);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int j = 0; j < D / 64; ++j)
        wgmma_n64<1>(o[j], pa[kc], descriptor(vs + j * kBN * 64 + kc * 16 * 64), 1);
    wgmma_commit_and_wait();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (tok[r] >= n) continue;
    const float inv = 1.f / l_run[r];
    bf16* dst = out + (static_cast<long long>(b) * n + tok[r]) * hd + h * d;
#pragma unroll
    for (int j = 0; j < D / 64; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * j + 8 * i + 2 * c;
        if (col < d)
          *reinterpret_cast<uint32_t*>(dst + col) =
              pack_bf16(o[j][4 * i + 2 * r] * inv, o[j][4 * i + 2 * r + 1] * inv);
      }
  }
}

// float32: thread x of block (x, y) takes query 64 x + threadIdx.x of pair y,
// its q and output in registers. Shared memory: rel_h and rel_w of every
// query ((gh + gw) x 64, a query a column), then kF32Keys keys of K and V.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
attention_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ th,
                     const float* __restrict__ tw, float* __restrict__ out,
                     int gh, int gw, int heads, int d, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* bias = reinterpret_cast<float*>(smem);
  float* ks = bias + (gh + gw) * kF32Threads;
  float* vs = ks + kF32Keys * D;
  const int tid = threadIdx.x;
  const int n = gh * gw, hd = heads * d;
  const int pair = blockIdx.y, b = pair / heads, h = pair - b * heads;
  const long long row = 3LL * hd;
  const float* base = qkv + static_cast<long long>(b) * n * row + h * d;
  const int tok = kF32Threads * blockIdx.x + tid;
  const int t = tok < n ? tok : 0, i = t / gw, j = t - i * gw;
  float q[D];
#pragma unroll
  for (int c = 0; c < D; ++c) q[c] = c < d ? base[t * row + c] : 0.f;
  for (int k = 0; k < gh + gw; ++k) {
    const float* tab = k < gh ? th + (i - k + gh - 1) * d
                              : tw + (j - (k - gh) + gw - 1) * d;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c)
      if (c < d) acc = fmaf(q[c], tab[c], acc);
    bias[k * kF32Threads + tid] = acc * kLog2e;
  }
  float o[D] = {};
  float m_run = -INFINITY, l_run = 0.f;
  for (int t0 = 0; t0 < n; t0 += kF32Keys) {
    __syncthreads();                  // the last step's K and V are read
    for (int idx = tid; idx < kF32Keys * D; idx += kF32Threads) {
      const int key = idx / D, c = idx - key * D;
      const bool ok = t0 + key < n && c < d;
      const float* src = base + (t0 + key) * row + c;
      ks[idx] = ok ? src[hd] : 0.f;
      vs[idx] = ok ? src[2 * hd] : 0.f;
    }
    __syncthreads();
    // One key at a time, the running maximum and sum updated with it.
#pragma unroll 1
    for (int kk = 0; kk < kF32Keys && t0 + kk < n; ++kk) {
      const int kt = t0 + kk, kr = kt / gw;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) acc = fmaf(q[c], ks[kk * D + c], acc);
      const float sc = fmaf(acc, scale, bias[kr * kF32Threads + tid]
                                            + bias[(gh + kt - kr * gw) * kF32Threads + tid]);
      const float m_new = fmaxf(m_run, sc);
      const float alpha = exp2f(m_run - m_new), p = exp2f(sc - m_new);
      m_run = m_new;
      l_run = fmaf(l_run, alpha, p);
#pragma unroll
      for (int c = 0; c < D; ++c) o[c] = fmaf(o[c], alpha, p * vs[kk * D + c]);
    }
  }
  if (tok >= n) return;
  float* dst = out + (static_cast<long long>(b) * n + tok) * hd + h * d;
#pragma unroll
  for (int c = 0; c < D; ++c)
    if (c < d) dst[c] = o[c] / l_run;
}

// Raise the kernel's dynamic shared memory limit to bytes on this device,
// once for each size it grows to.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&set_for)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 16) return cudaErrorInvalidDevice;
  if (bytes <= set_for[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) set_for[dev] = bytes;
  return err;
}

// The qkv projection's output (batch, gh, gw, 3 heads, d) as a 5-D tensor
// map whose boxes are one head's 64 (zero-padded) columns of GWP x 64 / GWP
// tokens of a batch, in 128-byte-swizzled rows: K and V tiles of the key
// loop. cuTensorMapEncodeTiled is looked up through the runtime, once, so
// the library needs no link to libcuda.
cudaError_t kv_tensor_map(CUtensorMap* map, const void* qkv, int batch, int gh,
                          int gw, int heads, int d, int sh) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(d), 3ull * heads,
                              static_cast<cuuint64_t>(gw), static_cast<cuuint64_t>(gh),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[4] = {d * e, 3ull * heads * d * e, 3ull * heads * d * gw * e,
                                 3ull * heads * d * gw * gh * e};
  const cuuint32_t box[5] = {64, 1, 1u << sh, static_cast<cuuint32_t>(kBN >> sh), 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                            const_cast<void*>(qkv), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
int launch_bf16(const void* qkv, const void* th, const void* tw, void* out,
                int batch, int gh, int gw, int heads, int d, float scale,
                cudaStream_t stream) {
  static int set_for[16] = {};
  int sh = 0;
  while ((1 << sh) < gw) ++sh;
  const int th_rows = pad64(2 * gh - 1), tw_rows = pad64(2 * gw - 1);
  const int bytes = 1024 + front_bytes<D>(th_rows, tw_rows) + kBM * (th_rows + 1) * 4
                    + 8 + kStages * 8;
  cudaError_t err = allow_smem(attention_bf16_kernel<D>, bytes, set_for);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap kv_map;
  err = kv_tensor_map(&kv_map, qkv, batch, gh, gw, heads, d, sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((gh * gw + kBM - 1) / kBM, batch * heads);
  attention_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(
      kv_map, static_cast<const bf16*>(qkv), static_cast<const bf16*>(th),
      static_cast<const bf16*>(tw), static_cast<bf16*>(out), gh, gw, heads, d,
      sh, th_rows, tw_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* qkv, const void* th, const void* tw, void* out,
               int batch, int gh, int gw, int heads, int d, float scale,
               cudaStream_t stream) {
  static int set_for[16] = {};
  const int bytes = ((gh + gw) * kF32Threads + 2 * kF32Keys * D) * 4;
  cudaError_t err = allow_smem(attention_f32_kernel<D>, bytes, set_for);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((gh * gw + kF32Threads - 1) / kF32Threads, batch * heads);
  attention_f32_kernel<D><<<grid, kF32Threads, bytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(th),
      static_cast<const float*>(tw), static_cast<float*>(out), gh, gw, heads,
      d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv: (batch, gh gw, 3 heads d), th: (2 gh - 1, d), tw: (2 gw - 1, d), out:
// (batch, gh gw, heads d), contiguous on the current device, bfloat16
// (is_f32 0) or float32 (is_f32 1), 16-byte aligned; grids up to 64 x 64, d
// a multiple of 16 up to 128, batch heads at most 65535. scale is d^-1/2
// log2 e. Launches on stream; returns the launch's cudaError_t (0 on success).
int dc_rel_pos_attention(const void* qkv, const void* th, const void* tw,
                         void* out, int batch, int gh, int gw, int heads, int d,
                         int is_f32, float scale, void* stream) {
  if (batch <= 0 || gh <= 0 || gw <= 0 || gh > 64 || gw > 64 || heads <= 0 ||
      d <= 0 || d > 128 || d % 16 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    if (d <= 32) return launch_f32<32>(qkv, th, tw, out, batch, gh, gw, heads, d, scale, s);
    if (d <= 64) return launch_f32<64>(qkv, th, tw, out, batch, gh, gw, heads, d, scale, s);
    return launch_f32<128>(qkv, th, tw, out, batch, gh, gw, heads, d, scale, s);
  }
  if (d <= 64) return launch_bf16<64>(qkv, th, tw, out, batch, gh, gw, heads, d, scale, s);
  return launch_bf16<128>(qkv, th, tw, out, batch, gh, gw, heads, d, scale, s);
}

}  // extern "C"
