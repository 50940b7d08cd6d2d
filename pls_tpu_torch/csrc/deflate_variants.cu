// Kernel variants of the fused deflation pass for Hopper (sm_90a): the
// kernels of the sweep `python -m pls_tpu_torch.tools.kernel_variants`.
//
// Replaces the three TPU kernels of tools/kernel_variants.py, all of which
// compute, for X (N, K) and r (K,) float32,
//
//     t = X r        (N,)
//     p = Xᵀ t       (K,)
//     tt = tᵀt       (inside the kernel, or outside as r·p or t·t)
//
// in one pass over X:
//   K3 `make_vpu_1k(tn, tt_inside, vmem_mb)` (lines 72-151): the VPU form
//      on f32 X (elementwise products and f32 sums) -> kernel `vpu_rows`;
//   K4 `make_mxu(tn, prec)` (lines 153-206): t and p as matrix-unit
//      matvecs at a given precision -> kernel `mxu_rows` (mma.sync);
//   K5 `make_vpu_bf16(tn, vmem_mb)` (lines 208-272): K3's form on bf16 X
//      widened in registers -> `vpu_rows` on bf16.
//
// What bounds them on the H100: bytes, as for the shipped kernel
// (csrc/deflate.cu, whose design these share): about 4·N·K flops for
// N·K·itemsize bytes, far below the card's ridge point.  The sweep exists
// to measure what moves the bytes in flight per SM.
//
// The TPU's knobs, and what they become here:
//   tn (rows per VMEM tile, 512-2048)  -> R, the rows per staged shared-
//       memory tile: at most 8 for the VPU form (8 warps share the rows),
//       16 for the mma form (the m16 of the instruction).  A TPU tile of
//       512 rows × K does not fit 227 KB; the requested R is lowered to the
//       largest power of two whose tiles fit the budget.
//   vmem_mb (scoped-VMEM grant)        -> smem_kb, the shared memory each
//       block reserves; blocks per SM = the SM's shared memory over that
//       reservation (227 KB: 1 block per SM; 110 KB: 2).
//   Pallas's double buffering          -> `stages`: 1 (load, then reduce)
//       or 2 (the next tile streams in with cp.async while this one is
//       reduced).
//   tt_inside (SMEM scalar)            -> each block sums tᵢ² of its rows in
//       tile order; a second pass sums the per-block partials in fixed
//       order.
//   prec (MXU passes: DEFAULT 1, HIGH 3, HIGHEST 6) -> the same number of
//       bf16 mma.sync m16n8k16 products with f32 accumulation:
//       DEFAULT  x₀·r₀, both rounded to bf16 (RNE); t is rounded to bf16
//                again before p = Xᵀt, as the TPU's matrix unit does;
//       HIGH     x₁·r₀ + x₀·r₁ + x₀·r₀ (hi/lo split, lo = bf16(x − hi));
//       HIGHEST  bf16×6 on a three-way split: x₂r₀ + x₁r₁ + x₀r₂ + x₁r₀ +
//                x₀r₁ + x₀r₀, smallest terms first.  It carries 24 bits of
//                each operand and holds the f32 contract (1e-5 relative).
//       r occupies column 0 of the n = 8 B operand (t likewise in the
//       second product): 1/8 of the instruction's output, the card's
//       counterpart of the TPU's 1/128 output lanes.
//
// Rules shared with csrc/deflate.cu (whose small helpers are repeated here
// so that each library builds from one file): a persistent grid that walks
// tiles of R contiguous rows; the ragged last tile is masked, never padded;
// 16-byte cp.async copies when K % vec == 0 and X is 16-byte aligned (r
// too, for the VPU form), plain loads otherwise; per-block p partials in a
// (G, K) buffer summed in fixed order by a second kernel, and scalars by a
// fixed tree, so that results are bit-identical from launch to launch;
// every launch on the caller's stream; nothing allocated here.  Only six
// kernel templates are instantiated (VPU f32/bf16 and mma f32, each with
// 16-byte and scalar staging); R, stages, tt_inside and the pass count are
// runtime parameters.
//
// Interface: plain C, loaded with ctypes (pls_tpu_torch/ops/deflate_variants.py).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kReduceThreads = 256;
constexpr int kSumThreads = 1024;
constexpr int kVpuMaxRows = kWarps;  // each staged row has 8/R warps
constexpr int kMmaRows = 16;         // the m16 of mma.m16n8k16

enum Kind { kVpuF32 = 0, kVpuBf16 = 1, kMxuF32 = 2 };

// ---------- helpers (as in csrc/deflate.cu) ----------

template <typename T, int V>
struct Chunk {
  using Raw = uint4;
};
template <typename T>
struct Chunk<T, 1> {
  using Raw = T;
};

template <typename T, int V>
__device__ __forceinline__ void widen(const typename Chunk<T, V>::Raw& raw, float (&out)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) {
      out[0] = raw;
    } else {
      out[0] = __bfloat162float(raw);
    }
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "f32 vector loads are 4 wide");
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  } else {
    static_assert(V == 8, "bf16 vector loads are 8 wide");
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void load_r(const float* __restrict__ p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = __ldg(p);
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + k);
      out[4 * k] = v.x;
      out[4 * k + 1] = v.y;
      out[4 * k + 2] = v.z;
      out[4 * k + 3] = v.w;
    }
  }
}

__host__ __device__ constexpr int64_t align16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// Dynamic shared memory: p accumulator, then `stages` buffers of R rows.
__host__ __device__ constexpr int64_t smem_bytes(int64_t K, int R, int stages, int elem) {
  return align16(K * 4) + static_cast<int64_t>(stages) * R * K * elem;
}

// Starts the copy of rows [row0, row0 + rows) of X into `buf`; commits one
// pipeline group (empty on the scalar path, whose stores are plain).
template <typename T, int V>
__device__ __forceinline__ void stage_rows(const T* __restrict__ X, T* buf, int64_t row0,
                                           int rows, int64_t K) {
  using Raw = typename Chunk<T, V>::Raw;
  const Raw* src = reinterpret_cast<const Raw*>(X + row0 * K);
  Raw* dst = reinterpret_cast<Raw*>(buf);
  const int64_t total = rows * (K / V);
  for (int64_t c = threadIdx.x; c < total; c += kThreads) {
    if constexpr (V > 1) {
      __pipeline_memcpy_async(dst + c, src + c, sizeof(Raw));
    } else {
      dst[c] = src[c];
    }
  }
  __pipeline_commit();
}

// The tile walk shared by both forms: block b reduces tiles b, b + G, ...
// of R rows, staged through `stages` shared-memory buffers.  `reduce(st,
// row0, rows)` runs on a staged tile with all threads; it must not touch
// the staging buffers' other stage.
template <typename T, int V, typename Reduce>
__device__ __forceinline__ void walk_tiles(const T* __restrict__ X, T* bufs, int64_t N,
                                           int64_t K, int R, int stages, Reduce reduce) {
  const int64_t buf_elems = static_cast<int64_t>(R) * K;
  const int64_t n_tiles = (N + R - 1) / R;
  auto rows_of = [&](int64_t tile_i) {
    return N - tile_i * R < R ? static_cast<int>(N - tile_i * R) : R;
  };
  if (blockIdx.x < n_tiles) {
    stage_rows<T, V>(X, bufs, static_cast<int64_t>(blockIdx.x) * R, rows_of(blockIdx.x), K);
  }
  int b = 0;
  for (int64_t tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    const int64_t next = tile_i + gridDim.x;
    if (stages == 2) {  // the next tile streams in while this one is reduced
      if (next < n_tiles) {
        stage_rows<T, V>(X, bufs + (b ^ 1) * buf_elems, next * R, rows_of(next), K);
      } else {
        __pipeline_commit();
      }
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    reduce(bufs + b * buf_elems, tile_i * R, rows_of(tile_i));
    __syncthreads();  // the buffer is rewritten next
    if (stages == 2) {
      b ^= 1;
    } else if (next < n_tiles) {
      stage_rows<T, V>(X, bufs, next * R, rows_of(next), K);
    }
  }
}

// ---------- K3 / K5: the VPU form ----------

// t of each staged row from 8/R warps' partial dots; p += Σ_rows xᵢ tᵢ into
// the block's accumulator; with tt_part, thread 0 also sums tᵢ² in tile
// order.  Writes the block's row of `partial` (and tt_part[block]).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
vpu_rows(const T* __restrict__ X, const float* __restrict__ r, float* __restrict__ t,
         float* __restrict__ partial, float* __restrict__ tt_part, int64_t N, int64_t K,
         int R, int stages) {
  using Raw = typename Chunk<T, V>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_acc = reinterpret_cast<float*>(smem);
  T* bufs = reinterpret_cast<T*>(smem + align16(K * 4));
  __shared__ float t_part[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wpr = kWarps / R;
  const int row = warp / wpr;
  const int seg = warp % wpr;
  const int64_t KV = K / V;
  float tt_acc = 0.f;

  for (int64_t c = threadIdx.x; c < K; c += kThreads) p_acc[c] = 0.f;

  walk_tiles<T, V>(X, bufs, N, K, R, stages, [&](const T* tile, int64_t row0, int rows) {
    const Raw* st = reinterpret_cast<const Raw*>(tile);
    float acc = 0.f;
    if (row < rows) {
      const Raw* si = st + row * KV;
#pragma unroll 4
      for (int64_t c = seg * 32 + lane; c < KV; c += 32 * wpr) {
        float x[V], rv[V];
        widen<T, V>(si[c], x);
        load_r<V>(r + c * V, rv);
#pragma unroll
        for (int e = 0; e < V; ++e) acc = fmaf(x[e], rv[e], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) t_part[warp] = acc;
    __syncthreads();

    float tr[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tr[w] = 0.f;
      if (w < rows) {
        for (int s = 0; s < wpr; ++s) tr[w] += t_part[w * wpr + s];
      }
    }
    if (threadIdx.x < rows) {
      float ti = 0.f;
      for (int s = 0; s < wpr; ++s) ti += t_part[threadIdx.x * wpr + s];
      t[row0 + threadIdx.x] = ti;
    }
    if (tt_part != nullptr && threadIdx.x == 0) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {  // constant indices keep tr in registers
        if (w < rows) tt_acc = fmaf(tr[w], tr[w], tt_acc);
      }
    }

    for (int64_t c = threadIdx.x; c < KV; c += kThreads) {
      float pa[V];
#pragma unroll
      for (int e = 0; e < V; ++e) pa[e] = p_acc[c * V + e];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < rows) {
          float x[V];
          widen<T, V>(st[w * KV + c], x);
#pragma unroll
          for (int e = 0; e < V; ++e) pa[e] = fmaf(x[e], tr[w], pa[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) p_acc[c * V + e] = pa[e];
    }
  });

  float* out = partial + static_cast<int64_t>(blockIdx.x) * K;
  for (int64_t c = threadIdx.x; c < K; c += kThreads) out[c] = p_acc[c];
  if (tt_part != nullptr && threadIdx.x == 0) tt_part[blockIdx.x] = tt_acc;
}

// ---------- K4: the mma form ----------

// x ≈ s[0] + s[1] + s[2], each rounded to bf16 to nearest even: s[0] =
// bf16(x), s[1] = bf16(x − s[0]), s[2] = bf16(x − s[0] − s[1]).  Only the
// first `n` are computed.
__device__ __forceinline__ void bf16_split(float x, int n, __nv_bfloat16 (&s)[3]) {
  s[0] = __float2bfloat16_rn(x);
  s[1] = s[2] = __float2bfloat16_rn(0.f);
  if (n > 1) {
    float rest = x - __bfloat162float(s[0]);
    s[1] = __float2bfloat16_rn(rest);
    if (n > 2) {
      rest -= __bfloat162float(s[1]);
      s[2] = __float2bfloat16_rn(rest);
    }
  }
}

// Two bf16 in one register, the lower index in the low half.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The split parts of W values, packed in pairs as an mma operand fragment.
template <int W>
__device__ __forceinline__ void split_fragment(const float (&v)[W], int n,
                                               uint32_t (&frag)[3][W / 2]) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    __nv_bfloat16 a[3], b[3];
    bf16_split(v[2 * i], n, a);
    bf16_split(v[2 * i + 1], n, b);
#pragma unroll
    for (int s = 0; s < 3; ++s) frag[s][i] = pack2(a[s], b[s]);
  }
}

// C += A B, A 16×16 bf16 (row), B 16×8 bf16 (col), C 16×8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The products of split parts (A part · B part), smallest first: 6 passes
// a₂b₀ a₁b₁ a₀b₂ a₁b₀ a₀b₁ a₀b₀, 3 passes the last three, 1 pass a₀b₀.
// (Constant indices keep the fragments in registers.)
__device__ __forceinline__ void mma_passes(float (&c)[4], const uint32_t (&a)[3][4],
                                           const uint32_t (&b)[3][2], int passes) {
  if (passes == 6) {
    mma_bf16(c, a[2], b[0]);
    mma_bf16(c, a[1], b[1]);
    mma_bf16(c, a[0], b[2]);
  }
  if (passes >= 3) {
    mma_bf16(c, a[1], b[0]);
    mma_bf16(c, a[0], b[1]);
  }
  mma_bf16(c, a[0], b[0]);
}

// Fragment coordinates of lane (g = lane / 4, q = lane % 4), PTX ISA
// m16n8k16: A element e at (row g + 8·bit1(e), col 2q + bit0(e) + 8·bit2(e));
// B element e at (k 2q + bit0(e) + 8·bit1(e), col g); C element e at
// (row g + 8·bit1(e), col 2q + bit0(e)).  Column 0 of C, the only one with
// a nonzero B column, is held by the lanes with q = 0.
__device__ __forceinline__ int a_row(int g, int e) { return g + 8 * ((e >> 1) & 1); }
__device__ __forceinline__ int a_col(int q, int e) { return 2 * q + (e & 1) + 8 * (e >> 2); }
__device__ __forceinline__ int b_k(int q, int e) { return 2 * q + (e & 1) + 8 * (e >> 1); }

// Per staged tile of R ≤ 16 rows (zero rows make up the m16):
//   phase 1: warp w takes column chunks w, w + 8, ... of 16, C = X_tile ·
//            [r 0 … 0] on each, and sums C[i, 0] over its chunks; tᵢ = the
//            warps' sums in warp order;
//   phase 2: t → the B operand (column 0); warp w owns column chunks w,
//            w + 8, ... of p for the whole launch: p_acc[chunk] +=
//            (X_tileᵀ[chunk] · [t 0 … 0])[:, 0].
// The tensor core sums only the 16 products of one instruction and the
// pass terms, with its own rounding; every longer sum (over column chunks
// for t, over tiles for p) is a float32 add outside it.  Kept as the mma
// accumulator, the running p drifted to 1.6e-5 relative at 100k × 5k at
// HIGHEST, past the f32 contract.
// Fragments are read from the staged f32 tile with scalar shared-memory
// loads (the Xᵀ operand is a strided read, no ldmatrix.trans), split in
// registers, masked at the ragged row and column edges.
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
mxu_rows(const float* __restrict__ X, const float* __restrict__ r, float* __restrict__ t,
         float* __restrict__ partial, int64_t N, int64_t K, int R, int stages, int passes) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_acc = reinterpret_cast<float*>(smem);
  float* bufs = reinterpret_cast<float*>(smem + align16(K * 4));
  __shared__ float t_part[kWarps][kMmaRows];
  __shared__ float t_tile[kMmaRows];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int nsplit = passes == 1 ? 1 : (passes == 3 ? 2 : 3);

  for (int64_t c = threadIdx.x; c < K; c += kThreads) p_acc[c] = 0.f;

  walk_tiles<float, V>(X, bufs, N, K, R, stages, [&](const float* tile, int64_t row0, int rows) {
    // phase 1: t = X_tile r
    float t_lo = 0.f, t_hi = 0.f;  // rows g and g + 8, column 0 (lanes q = 0)
    for (int64_t k0 = static_cast<int64_t>(warp) * 16; k0 < K; k0 += kWarps * 16) {
      float av[8], bv[4];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = a_row(g, e);
        const int64_t k = k0 + a_col(q, e);
        av[e] = (i < rows && k < K) ? tile[i * K + k] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t k = k0 + b_k(q, e);
        bv[e] = (g == 0 && k < K) ? __ldg(r + k) : 0.f;
      }
      uint32_t a[3][4], b[3][2];
      split_fragment<8>(av, nsplit, a);
      split_fragment<4>(bv, nsplit, b);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_passes(c, a, b, passes);
      t_lo += c[0];
      t_hi += c[2];
    }
    if (q == 0) {
      t_part[warp][g] = t_lo;
      t_part[warp][g + 8] = t_hi;
    }
    __syncthreads();
    if (threadIdx.x < kMmaRows) {
      float ti = 0.f;
      for (int w = 0; w < kWarps; ++w) ti += t_part[w][threadIdx.x];
      t_tile[threadIdx.x] = threadIdx.x < rows ? ti : 0.f;
      if (threadIdx.x < rows) t[row0 + threadIdx.x] = ti;
    }
    __syncthreads();

    // phase 2: p += X_tileᵀ t, t rounded (DEFAULT) or split like r
    float bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = g == 0 ? t_tile[b_k(q, e)] : 0.f;
    uint32_t b[3][2];
    split_fragment<4>(bv, nsplit, b);
    for (int64_t j0 = static_cast<int64_t>(warp) * 16; j0 < K; j0 += kWarps * 16) {
      float av[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int64_t j = j0 + a_row(g, e);  // A = X_tileᵀ: rows are columns of X
        const int i = a_col(q, e);
        av[e] = (i < rows && j < K) ? tile[i * K + j] : 0.f;
      }
      uint32_t a[3][4];
      split_fragment<8>(av, nsplit, a);
      const int64_t j_lo = j0 + g, j_hi = j0 + g + 8;
      float cp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_passes(cp, a, b, passes);
      if (q == 0) {
        if (j_lo < K) p_acc[j_lo] += cp[0];
        if (j_hi < K) p_acc[j_hi] += cp[2];
      }
    }
  });

  float* out = partial + static_cast<int64_t>(blockIdx.x) * K;
  for (int64_t c = threadIdx.x; c < K; c += kThreads) out[c] = p_acc[c];
}

// ---------- fixed-order reductions ----------

// p[j] = Σ_g partial[g, j], g in increasing order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const float* __restrict__ partial, float* __restrict__ p, int64_t G,
                int64_t K) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (j >= K) return;
  float s = 0.f;
  for (int64_t g = 0; g < G; ++g) s += partial[g * K + j];
  p[j] = s;
}

// out = Σ a[j]·b[j] (Σ a[j] when b is null) in one block, by a fixed tree.
__global__ void __launch_bounds__(kSumThreads)
tree_sum(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
         int64_t n) {
  __shared__ float red[kSumThreads];
  float s = 0.f;
  for (int64_t j = threadIdx.x; j < n; j += kSumThreads) s = b ? fmaf(a[j], b[j], s) : s + a[j];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kSumThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = red[0];
}

// ---------- planning and launch ----------

template <typename Kern>
cudaError_t plan_kernel(Kern kern, int elem, int max_rows, int64_t N, int64_t K, int rows,
                        int stages, int smem_kb, int64_t* G, int* R, int* per_sm) {
  int dev = 0, optin = 0, sms = 0, sm_smem = 0, reserved = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  const int cap = optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  if (err != cudaSuccess) return err;
  // the block's reservation, static shared memory included
  const int budget = smem_kb > 0 && smem_kb * 1024 < optin ? smem_kb * 1024 : optin;
  *per_sm = sm_smem / (budget + reserved) > 0 ? sm_smem / (budget + reserved) : 1;
  const int64_t dyn = budget - static_cast<int64_t>(attr.sharedSizeBytes);
  int want = rows < max_rows ? rows : max_rows;
  *R = 1;
  while (*R * 2 <= want) *R *= 2;
  while (*R >= 1 && smem_bytes(K, *R, stages, elem) > dyn) *R /= 2;
  const int64_t tiles = *R > 0 ? (N + *R - 1) / *R : 0;
  const int64_t blocks = static_cast<int64_t>(*per_sm) * sms;
  *G = blocks < tiles ? blocks : tiles;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// kind: 0 = VPU f32 (K3), 1 = VPU bf16 (K5), 2 = mma f32 (K4).  vec: 1, or
// 4 (f32) / 8 (bf16) for 16-byte copies, which the caller may choose only
// when K % vec == 0 and X and r are 16-byte aligned.

// Plans one variant for this shape on the current device: *R, the rows per
// staged tile (the largest power of two ≤ rows, and ≤ 8 VPU / 16 mma, whose
// `stages` buffers and the p accumulator fit the block's reservation of
// smem_kb KB, ≤ 0 for the device's maximum; 0 when not one row fits), *G,
// the blocks (rows of the partial buffer), and *per_sm, the blocks per SM
// the reservation allows.  Raises the kernel's dynamic shared memory limit
// to the device's maximum.  Returns a cudaError_t (0 = planned).
int kv_plan(int kind, int vec, int64_t N, int64_t K, int rows, int stages, int smem_kb,
            int64_t* G, int* R, int* per_sm) {
  if (stages != 1 && stages != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kVpuF32 && vec == 4) {
    return plan_kernel(vpu_rows<float, 4>, 4, kVpuMaxRows, N, K, rows, stages, smem_kb, G, R, per_sm);
  }
  if (kind == kVpuF32 && vec == 1) {
    return plan_kernel(vpu_rows<float, 1>, 4, kVpuMaxRows, N, K, rows, stages, smem_kb, G, R, per_sm);
  }
  if (kind == kVpuBf16 && vec == 8) {
    return plan_kernel(vpu_rows<__nv_bfloat16, 8>, 2, kVpuMaxRows, N, K, rows, stages, smem_kb,
                       G, R, per_sm);
  }
  if (kind == kVpuBf16 && vec == 1) {
    return plan_kernel(vpu_rows<__nv_bfloat16, 1>, 2, kVpuMaxRows, N, K, rows, stages, smem_kb,
                       G, R, per_sm);
  }
  if (kind == kMxuF32 && vec == 4) {
    return plan_kernel(mxu_rows<4>, 4, kMmaRows, N, K, rows, stages, smem_kb, G, R, per_sm);
  }
  if (kind == kMxuF32 && vec == 1) {
    return plan_kernel(mxu_rows<1>, 4, kMmaRows, N, K, rows, stages, smem_kb, G, R, per_sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the planned variant on `stream`: the tile kernel, the fixed-order
// sum of the partial rows into p, and tt: Σ tt_part (tt_inside), t·t (mma
// form, as the TPU tool takes it outside its kernel) or r·p.  passes (mma
// form only): 1, 3 or 6.  Returns cudaGetLastError() (0 = launched).
int kv_launch(int kind, int vec, const void* X, const float* r, float* t, float* p, float* tt,
              float* partial, float* tt_part, int64_t N, int64_t K, int64_t G, int R,
              int stages, int tt_inside, int passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(G);
  float* ttp = tt_inside ? tt_part : nullptr;
  if (R < 1 || G < 1 || (stages != 1 && stages != 2) || (tt_inside && tt_part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kind == kVpuF32) {
    const size_t bytes = static_cast<size_t>(smem_bytes(K, R, stages, 4));
    const float* Xf = static_cast<const float*>(X);
    if (vec == 4) {
      vpu_rows<float, 4><<<grid, kThreads, bytes, s>>>(Xf, r, t, partial, ttp, N, K, R, stages);
    } else if (vec == 1) {
      vpu_rows<float, 1><<<grid, kThreads, bytes, s>>>(Xf, r, t, partial, ttp, N, K, R, stages);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (kind == kVpuBf16) {
    const size_t bytes = static_cast<size_t>(smem_bytes(K, R, stages, 2));
    const __nv_bfloat16* Xb = static_cast<const __nv_bfloat16*>(X);
    if (vec == 8) {
      vpu_rows<__nv_bfloat16, 8><<<grid, kThreads, bytes, s>>>(Xb, r, t, partial, ttp, N, K, R,
                                                                stages);
    } else if (vec == 1) {
      vpu_rows<__nv_bfloat16, 1><<<grid, kThreads, bytes, s>>>(Xb, r, t, partial, ttp, N, K, R,
                                                                stages);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (kind == kMxuF32) {
    if (passes != 1 && passes != 3 && passes != 6) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = static_cast<size_t>(smem_bytes(K, R, stages, 4));
    const float* Xf = static_cast<const float*>(X);
    if (vec == 4) {
      mxu_rows<4><<<grid, kThreads, bytes, s>>>(Xf, r, t, partial, N, K, R, stages, passes);
    } else if (vec == 1) {
      mxu_rows<1><<<grid, kThreads, bytes, s>>>(Xf, r, t, partial, N, K, R, stages, passes);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t reduce_blocks = (K + kReduceThreads - 1) / kReduceThreads;
  reduce_partials<<<static_cast<unsigned>(reduce_blocks), kReduceThreads, 0, s>>>(partial, p, G,
                                                                                  K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kind == kMxuF32) {
    tree_sum<<<1, kSumThreads, 0, s>>>(t, t, tt, N);
  } else if (tt_inside) {
    tree_sum<<<1, kSumThreads, 0, s>>>(tt_part, nullptr, tt, G);
  } else {
    tree_sum<<<1, kSumThreads, 0, s>>>(r, p, tt, K);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kv_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
