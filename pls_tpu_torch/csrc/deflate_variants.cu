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
//      matvecs at a given precision -> bf16 mma.sync on split f32 X:
//      `mxu_ring` where X rows move in 16-byte units (a producer warp keeps
//      a ring of 8-row TMA slots in flight; the rows on the n = 8 side for
//      t, p by m16n8k8), `mxu_rows` (scalar-staged tiles of ≤ 16 rows on
//      the m16 side) otherwise.  What bounds K4 is bytes, as below; what
//      held it at a third of that bound was shared memory (every fragment
//      load eight lanes a bank), r re-split on every tile, two barriers a
//      tile, no overlap of load and reduce at 16 rows, and a runtime pass
//      count (DEFAULT took as long as HIGHEST).
//      Both kernels stage rows at a padded pitch (`mxu_pitch`: at most two
//      lanes a bank), split r once per block into bf16 planes, sum t behind
//      one barrier a tile, and are instantiated per precision; the ring's
//      8-row slots (64 KB at K = 2048, so three fit) let the copies of the
//      next tiles run under the products of this one;
//   K5 `make_vpu_bf16(tn, vmem_mb)` (lines 208-272): K3's form on bf16 X
//      widened in registers -> `vpu_rows` on bf16, and the column-owning
//      design of csrc/deflate_common.cuh (`deflate_cols<W, B>`, K2's design
//      on the shipped path) with W = 16 or 8 consumer warps, B = 1 or 2
//      blocks per SM and a ring of 2-8 TMA slots -> the `cols_bf16` rows.
//
// What bounds them on the H100: bytes, as for the shipped kernel
// (csrc/deflate.cu, whose design these share): about 4·N·K flops for
// N·K·itemsize bytes, far below the card's ridge point.  The sweep exists
// to measure what moves the bytes in flight per SM.
//
// The TPU's knobs, and what they become here:
//   tn (rows per VMEM tile, 512-2048)  -> R, the rows per staged shared-
//       memory tile: at most 8 for the VPU form (8 warps share the rows),
//       16 for the scalar-staged mma form (the m16 of the instruction);
//       K4's ring takes 8 rows a slot whatever tn.  A TPU tile of 512 rows
//       × K does not fit 227 KB; the requested R is lowered to the largest
//       power of two whose tiles fit the budget.
//   vmem_mb (scoped-VMEM grant)        -> smem_kb, the shared memory each
//       block reserves; blocks per SM = the SM's shared memory over that
//       reservation (227 KB: 1 block per SM; 110 KB: 2).
//   Pallas's double buffering          -> `stages`: 1 (load, then reduce)
//       or 2 (the next tile streams in with cp.async while this one is
//       reduced); for K4's ring, its slots (1-4, as many as fit).
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
//       r occupies one row or column of an operand (t likewise in the
//       second product): 1/8 or 1/16 of the instruction's output, the
//       card's counterpart of the TPU's 1/128 output lanes.
//
// Rules shared with csrc/deflate.cu (whose helpers, fixed-order reductions
// and column-owning kernel are in csrc/deflate_common.cuh, included by
// both): a persistent grid that walks tiles of R contiguous rows; the
// ragged last tile is masked, never padded;
// 16-byte cp.async copies when K % vec == 0 and X is 16-byte aligned (r
// too, for the VPU form), plain loads otherwise; per-block p partials in a
// (G, K) buffer summed in fixed order by a second kernel, and scalars by a
// fixed tree, so that results are bit-identical from launch to launch;
// every launch on the caller's stream; nothing allocated here.  Kernel
// templates are instantiated for the VPU form (f32/bf16, each with 16-byte
// and scalar staging), K4 (ring and scalar-staged, each at three
// precisions) and the column-owning design (two configurations); R, S,
// stages and tt_inside are runtime parameters.
//
// Interface: plain C, loaded with ctypes (pls_tpu_torch/ops/deflate_variants.py).

#include "deflate_common.cuh"

namespace {

constexpr int kVpuMaxRows = kWarps;  // each staged row has 8/R warps
constexpr int kMmaRows = 16;         // the m16 of mma.m16n8k16

enum Kind { kVpuF32 = 0, kVpuBf16 = 1, kMxuF32 = 2 };

// Dynamic shared memory: p accumulator, then `stages` buffers of R rows.
__host__ __device__ constexpr int64_t smem_bytes(int64_t K, int R, int stages, int elem) {
  return align16(K * 4) + static_cast<int64_t>(stages) * R * K * elem;
}

// Starts the copy of rows [row0, row0 + rows) of X into `buf`, whose rows
// are `pitch` elements apart, as stage_rows does for pitch == K.
template <typename T, int V>
__device__ __forceinline__ void stage_rows_pitched(const T* __restrict__ X, T* buf,
                                                   int64_t row0, int rows, int64_t K,
                                                   int64_t pitch) {
  using Raw = typename Chunk<T, V>::Raw;
  const int64_t KV = K / V;
  const Raw* src = reinterpret_cast<const Raw*>(X + row0 * K);
  for (int i = 0; i < rows; ++i) {
    Raw* dst = reinterpret_cast<Raw*>(buf + i * pitch);
    for (int64_t c = threadIdx.x; c < KV; c += kThreads) {
      if constexpr (V > 1) {
        __pipeline_memcpy_async(dst + c, src + i * KV + c, sizeof(Raw));
      } else {
        dst[c] = src[i * KV + c];
      }
    }
  }
  __pipeline_commit();
}

// The tile walk shared by both forms: block b reduces tiles b, b + G, ...
// of R rows, staged through `stages` shared-memory buffers whose rows are
// `pitch` elements apart (K for the VPU form).  `reduce(st, row0, rows)`
// runs on a staged tile with all threads; it must not touch the staging
// buffers' other stage.
template <typename T, int V, typename Reduce>
__device__ __forceinline__ void walk_tiles(const T* __restrict__ X, T* bufs, int64_t N,
                                           int64_t K, int64_t pitch, int R, int stages,
                                           Reduce reduce) {
  const int64_t buf_elems = static_cast<int64_t>(R) * pitch;
  const int64_t n_tiles = (N + R - 1) / R;
  auto rows_of = [&](int64_t tile_i) {
    return N - tile_i * R < R ? static_cast<int>(N - tile_i * R) : R;
  };
  auto stage = [&](T* buf, int64_t tile_i) {
    if (pitch == K) {
      stage_rows<T, V>(X, buf, tile_i * R, rows_of(tile_i), K);
    } else {
      stage_rows_pitched<T, V>(X, buf, tile_i * R, rows_of(tile_i), K, pitch);
    }
  };
  if (blockIdx.x < n_tiles) stage(bufs, blockIdx.x);
  int b = 0;
  for (int64_t tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
    const int64_t next = tile_i + gridDim.x;
    if (stages == 2) {  // the next tile streams in while this one is reduced
      if (next < n_tiles) {
        stage(bufs + (b ^ 1) * buf_elems, next);
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
      stage(bufs, next);
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

  walk_tiles<T, V>(X, bufs, N, K, K, R, stages, [&](const T* tile, int64_t row0, int rows) {
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

// The bf16 products of each precision: DEFAULT 1 part a operand, 1 pass;
// HIGH 2 parts, 3 passes; HIGHEST 3 parts, 6 passes.  Every K4 kernel is
// instantiated per split count NS, so that a precision issues only its own
// instructions (with a runtime count all three took the same time).
__host__ __device__ constexpr int passes_of(int NS) { return NS == 1 ? 1 : (NS == 2 ? 3 : 6); }

// The row pitch of K4's staged tiles, in floats: the least P ≥ K rounded
// up to 16 (whole 16-column chunks, the pad kept zero) with P ≡ 8 (mod
// 32).  In 4-byte banks: an 8-byte load of adjacent columns 2q, 2q + 1 at
// row g (a half-warp: g = 0..3, q = 0..3) falls on words 8g + 2q + {0, 1}
// mod 32, sixteen distinct bank pairs, no conflict; a scalar load at rows
// 2q + b, column g on words 16q + 8b + g, two lanes a bank.  With P a
// multiple of 32 (K = 2048 unpadded) every fragment load was eight lanes a
// bank.
__host__ __device__ constexpr int64_t mxu_pitch(int64_t K) {
  return (K + 15) / 16 * 16 + ((K + 15) / 16 * 16 % 32 == 0 ? 8 : 24);
}

// Shared memory before K4's tiles: the p accumulator and the bf16 parts
// of r, NS planes of mxu_pitch(K).
__host__ __device__ constexpr int64_t mxu_fixed_bytes(int64_t K, int NS) {
  return align16(K * 4) + align16(NS * mxu_pitch(K) * 2);
}

// Two bf16 in one register, the lower index in the low half.
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x0 and x1 split into NS bf16 parts each, rounded to nearest even, packed
// in pairs (x0's part in the low half): s[0] = bf16(x), s[1] = bf16(x −
// s[0]), s[2] = bf16(x − s[0] − s[1]).  Each step converts both values
// with one cvt.rn.bf16x2.f32.
template <int NS>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&s)[NS]) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  s[0] = bf16x2_bits(h);
#pragma unroll
  for (int i = 1; i < NS; ++i) {
    const float2 f = __bfloat1622float2(h);
    x0 -= f.x;
    x1 -= f.y;
    h = __floats2bfloat162_rn(x0, x1);
    s[i] = bf16x2_bits(h);
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

// C += A B, A 16×8 bf16 (row), B 8×8 bf16 (col), C 16×8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[2],
                                         const uint32_t (&b)[1]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b[0]));
}

// The products of split parts (A part · B part), smallest first: HIGHEST
// a₂b₀ a₁b₁ a₀b₂ a₁b₀ a₀b₁ a₀b₀, HIGH the last three, DEFAULT a₀b₀.  The
// term set is symmetric, so which operand is X does not change it.
template <int NS, int RA, int RB>
__device__ __forceinline__ void mma_passes(float (&c)[4], const uint32_t (&a)[NS][RA],
                                           const uint32_t (&b)[NS][RB]) {
  if constexpr (NS == 3) {
    mma_bf16(c, a[2], b[0]);
    mma_bf16(c, a[1], b[1]);
    mma_bf16(c, a[0], b[2]);
  }
  if constexpr (NS >= 2) {
    mma_bf16(c, a[1], b[0]);
    mma_bf16(c, a[0], b[1]);
  }
  mma_bf16(c, a[0], b[0]);
}

// r split once per block: NS planes of bf16 parts in shared memory,
// mxu_pitch(K) long, zero past K.
template <int NS>
__device__ __forceinline__ void split_r(const float* __restrict__ r, __nv_bfloat16* planes,
                                        int64_t K, int64_t P) {
  for (int64_t k = 2 * threadIdx.x; k < P; k += 2 * blockDim.x) {
    uint32_t s[NS];
    split2<NS>(k < K ? __ldg(r + k) : 0.f, k + 1 < K ? __ldg(r + k + 1) : 0.f, s);
#pragma unroll
    for (int i = 0; i < NS; ++i) *reinterpret_cast<uint32_t*>(planes + i * P + k) = s[i];
  }
}

// Fragment coordinates of lane (g = lane / 4, q = lane % 4), PTX ISA:
// m16n8k16 A register j holds the elements at row g + 8·(j & 1), columns
// 2q + 8·(j >> 1) and the next; B register j at k 2q + 8j and the next,
// column g; m16n8k8 A register j at row g + 8j, columns 2q and the next,
// B at k 2q and the next, column g; C of both, elements e at row
// g + 8·bit1(e), column 2q + bit0(e).
// The tensor core sums only the products of one instruction and the pass
// terms, with its own rounding; every longer sum (over column chunks for
// t, over tiles for p) is a float32 add outside it.  Kept as the mma
// accumulator, the running p drifted to 1.6e-5 relative at 100k × 5k at
// HIGHEST, past the f32 contract.

// K4 on the scalar-staged path (K % 4 != 0, or X not 16-byte aligned):
// tiles of R ≤ 16 rows staged with plain loads at mxu_pitch(K), rows on
// the m16 side (rows past the tile make up the m16):
//   phase 1: warp w takes column chunks w, w + 8, ... of 16, C = X_tile ·
//            [r 0 … 0] on each (A by 8-byte loads of adjacent columns, B
//            from r's planes), and sums C[i, 0] over its chunks; tᵢ = the
//            warps' sums in warp order, behind the tile's one barrier;
//   phase 2: t → the B operand (column 0); warp w owns column chunks w,
//            w + 8, ... of p for the whole launch: p_acc[chunk] +=
//            (X_tileᵀ[chunk] · [t 0 … 0])[:, 0].
// The pad columns are zeroed once, so no load is masked by column; rows
// past the tile are masked where they would meet a finite operand.
template <int NS>
__global__ void __launch_bounds__(kThreads, 2)
mxu_rows(const float* __restrict__ X, const float* __restrict__ r, float* __restrict__ t,
         float* __restrict__ partial, int64_t N, int64_t K, int R, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t P = mxu_pitch(K);
  float* p_acc = reinterpret_cast<float*>(smem);
  __nv_bfloat16* r_parts = reinterpret_cast<__nv_bfloat16*>(smem + align16(K * 4));
  float* bufs = reinterpret_cast<float*>(smem + mxu_fixed_bytes(K, NS));
  __shared__ float t_part[kWarps][kMmaRows];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int q = lane % 4;

  for (int64_t c = threadIdx.x; c < K; c += kThreads) p_acc[c] = 0.f;
  split_r<NS>(r, r_parts, K, P);
  const int64_t pad = P - K;
  for (int64_t e = threadIdx.x; e < stages * R * pad; e += kThreads) {
    bufs[(e / pad) * P + K + e % pad] = 0.f;
  }

  walk_tiles<float, 1>(X, bufs, N, K, P, R, stages,
                       [&](const float* tile, int64_t row0, int rows) {
    // phase 1: t = X_tile r
    const bool lo_ok = g < rows, hi_ok = g + 8 < rows;
    const float* x_lo = tile + g * P + 2 * q;
    const float* x_hi = x_lo + 8 * P;
    const float2 zero2 = make_float2(0.f, 0.f);
    float t_lo = 0.f, t_hi = 0.f;  // rows g and g + 8, column 0 (lanes q = 0)
#pragma unroll 2
    for (int64_t k0 = static_cast<int64_t>(warp) * 16; k0 < K; k0 += kWarps * 16) {
      float2 v[4];
      v[0] = lo_ok ? *reinterpret_cast<const float2*>(x_lo + k0) : zero2;
      v[1] = hi_ok ? *reinterpret_cast<const float2*>(x_hi + k0) : zero2;
      v[2] = lo_ok ? *reinterpret_cast<const float2*>(x_lo + k0 + 8) : zero2;
      v[3] = hi_ok ? *reinterpret_cast<const float2*>(x_hi + k0 + 8) : zero2;
      uint32_t a[NS][4], b[NS][2], s[NS];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split2<NS>(v[j].x, v[j].y, s);
#pragma unroll
        for (int i = 0; i < NS; ++i) a[i][j] = s[i];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const __nv_bfloat16* rp = r_parts + i * P + k0 + 2 * q;
        b[i][0] = g == 0 ? *reinterpret_cast<const uint32_t*>(rp) : 0u;
        b[i][1] = g == 0 ? *reinterpret_cast<const uint32_t*>(rp + 8) : 0u;
      }
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_passes<NS>(c, a, b);
      t_lo += c[0];
      t_hi += c[2];
    }
    if (q == 0) {
      t_part[warp][g] = t_lo;
      t_part[warp][g + 8] = t_hi;
    }
    __syncthreads();  // the tile's one barrier: walk_tiles' orders the next
    auto t_of = [&](int i) {  // tᵢ: the warps' sums in warp order, 0 past the tile
      float ti = 0.f;
      for (int w = 0; w < kWarps; ++w) ti += t_part[w][i];
      return i < rows ? ti : 0.f;
    };
    if (threadIdx.x < rows) t[row0 + threadIdx.x] = t_of(threadIdx.x);

    // phase 2: p += X_tileᵀ t, t rounded (DEFAULT) or split like r
    uint32_t b[NS][2] = {};
    if (g == 0) {
      uint32_t s[NS];
      split2<NS>(t_of(2 * q), t_of(2 * q + 1), s);
#pragma unroll
      for (int i = 0; i < NS; ++i) b[i][0] = s[i];
      split2<NS>(t_of(2 * q + 8), t_of(2 * q + 9), s);
#pragma unroll
      for (int i = 0; i < NS; ++i) b[i][1] = s[i];
    }
    // A = X_tileᵀ: register j at column j0 + g + 8·(j & 1) of X, rows
    // 2q + 8·(j >> 1) and the next
    bool ok[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) ok[e] = 2 * q + (e & 1) + 8 * (e >> 1) < rows;
    for (int64_t j0 = static_cast<int64_t>(warp) * 16; j0 < K; j0 += kWarps * 16) {
      uint32_t a[NS][4], s[NS];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i0 = 2 * q + 8 * (j >> 1);
        const float* col = tile + j0 + g + 8 * (j & 1);
        const float x0 = ok[2 * (j >> 1)] ? col[i0 * P] : 0.f;
        const float x1 = ok[2 * (j >> 1) + 1] ? col[(i0 + 1) * P] : 0.f;
        split2<NS>(x0, x1, s);
#pragma unroll
        for (int i = 0; i < NS; ++i) a[i][j] = s[i];
      }
      float cp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_passes<NS>(cp, a, b);
      const int64_t j_lo = j0 + g, j_hi = j0 + g + 8;
      if (q == 0) {
        if (j_lo < K) p_acc[j_lo] += cp[0];
        if (j_hi < K) p_acc[j_hi] += cp[2];
      }
    }
  });

  float* out = partial + static_cast<int64_t>(blockIdx.x) * K;
  for (int64_t c = threadIdx.x; c < K; c += kThreads) out[c] = p_acc[c];
}

// ---------- K4 on the 16-byte path: a ring of 8-row slots ----------

constexpr int kMxuRows = 8;       // rows of a ring slot: the n = 8 of mma.m16n8k16
constexpr int kMxuWarps = 8;      // consumer warps
constexpr int kMxuMaxStages = 4;  // slots of the ring
constexpr int kMxuBarrier = 1;    // named barrier of the consumer warps (0 is __syncthreads)

// Block b reduces tiles b, b + G, ... of kMxuRows rows; writes t of its
// rows and its row b of `partial`.  kMxuWarps consumer warps and one
// producer warp, one block per SM.  The ring's slots hold kMxuRows rows
// of mxu_pitch(K) floats each, after the p accumulator and r's planes.
//   The producer's one thread keeps `stages` slots in flight: one TMA
//   bulk copy a row (the pitch is not K, so a tile is not one copy), all
//   completing on the slot's `full` mbarrier.
//   Phase 1, t = X_tile r with the tile's rows on the n = 8 side of
//   m16n8k16: A = r's parts in row 0 (from the planes, lanes g = 0),
//   B = the 16-column by 8-row block of X_tileᵀ at chunk k0, whose
//   register j is X[g, k0 + 2q + 8j] and the next: one 8-byte load, free
//   of bank conflicts at the pitch.  C[0, n] (lanes g = 0: columns 2q,
//   2q + 1) is row n's dot over the chunk; warp w sums its chunks w, w +
//   8, ..., in order.  Rows past the tile reach only their own columns.
//   The warps' sums meet in a double-buffered array behind one named
//   barrier of the consumer warps; every reader sums them in warp order.
//   Phase 2, p += X_tileᵀ t by m16n8k8: A = the 16-column by 8-row block
//   of X_tileᵀ (register 0 at column j0 + g, rows 2q and 2q + 1; register
//   1 at column j0 + g + 8), B = t's parts in column 0 (lanes g = 0), rows
//   past the tile masked to 0 on both sides; warp w owns p's chunks w, w +
//   8, ... for the whole launch, takes two of them per step (their loads
//   are issued before either accumulator update) and adds C[:, 0] to them
//   in float32.
//   Each warp arrives on the slot's `empty` mbarrier when both phases are
//   done with it.
template <int NS>
__global__ void __launch_bounds__((kMxuWarps + 1) * 32, 1)
mxu_ring(const float* __restrict__ X, const float* __restrict__ r, float* __restrict__ t,
         float* __restrict__ partial, int64_t N, int64_t K, int stages) {
  constexpr int T = kMxuWarps * 32;  // consumer threads
  constexpr int kStep = kMxuWarps * 16;  // columns between a warp's chunks
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMxuMaxStages];
  __shared__ __align__(8) uint64_t empty[kMxuMaxStages];
  __shared__ float red[2][kMxuWarps][kMxuRows];  // tile parity, warp, row
  const int64_t P = mxu_pitch(K);
  float* p_acc = reinterpret_cast<float*>(smem);
  __nv_bfloat16* r_parts = reinterpret_cast<__nv_bfloat16*>(smem + align16(K * 4));
  float* ring = reinterpret_cast<float*>(smem + mxu_fixed_bytes(K, NS));
  const int64_t slot_elems = kMxuRows * P;
  const int64_t n_tiles = (N + kMxuRows - 1) / kMxuRows;
  const int tid = threadIdx.x;

  // all threads: p = 0, r split once, the pad columns of every slot zeroed
  // (the copies never write them; fragments read whole 16-column chunks)
  for (int64_t c = tid; c < K; c += blockDim.x) p_acc[c] = 0.f;
  split_r<NS>(r, r_parts, K, P);
  const int64_t pad = P - K;
  for (int64_t e = tid; e < stages * kMxuRows * pad; e += blockDim.x) {
    ring[(e / pad) * P + K + e % pad] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kMxuWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= T) {  // the producer warp: one thread keeps the ring full
    if (tid == T) {
      const uint32_t row_bytes = static_cast<uint32_t>(K * 4);
      int n = 0;
      for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++n) {
        const int slot = n % stages;
        mbar_wait(&empty[slot], ((n / stages) & 1) ^ 1);
        const int64_t row0 = tile * kMxuRows;
        const int rows = N - row0 < kMxuRows ? static_cast<int>(N - row0) : kMxuRows;
        mbar_expect_tx(&full[slot], rows * row_bytes);
        float* dst = ring + slot * slot_elems;
        for (int i = 0; i < rows; ++i) {
          bulk_copy_g2s(dst + i * P, X + (row0 + i) * K, row_bytes, &full[slot]);
        }
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  int n = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++n) {
    const int slot = n % stages;
    const int64_t row0 = tile * kMxuRows;
    const int rows = N - row0 < kMxuRows ? static_cast<int>(N - row0) : kMxuRows;
    const float* x = ring + slot * slot_elems;
    mbar_wait(&full[slot], (n / stages) & 1);

    // phase 1
    const float* xg = x + g * P + 2 * q;
    float t0 = 0.f, t1 = 0.f;  // lanes g = 0: rows 2q and 2q + 1
#pragma unroll 2
    for (int64_t k0 = static_cast<int64_t>(warp) * 16; k0 < K; k0 += kStep) {
      const float2 v0 = *reinterpret_cast<const float2*>(xg + k0);
      const float2 v1 = *reinterpret_cast<const float2*>(xg + k0 + 8);
      uint32_t a[NS][4], b[NS][2], s[NS];
      split2<NS>(v0.x, v0.y, s);
#pragma unroll
      for (int i = 0; i < NS; ++i) b[i][0] = s[i];
      split2<NS>(v1.x, v1.y, s);
#pragma unroll
      for (int i = 0; i < NS; ++i) b[i][1] = s[i];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const __nv_bfloat16* rp = r_parts + i * P + k0 + 2 * q;
        a[i][0] = g == 0 ? *reinterpret_cast<const uint32_t*>(rp) : 0u;
        a[i][2] = g == 0 ? *reinterpret_cast<const uint32_t*>(rp + 8) : 0u;
        a[i][1] = a[i][3] = 0u;
      }
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_passes<NS>(c, a, b);
      t0 += c[0];
      t1 += c[1];
    }
    float(*rd)[kMxuRows] = red[n & 1];
    if (g == 0) {
      rd[warp][2 * q] = t0;
      rd[warp][2 * q + 1] = t1;
    }
    named_barrier(kMxuBarrier, T);

    // t of rows 2q, 2q + 1 (lanes g = 0), 0 past the tile: phase 2's B
    uint32_t bt[NS][1] = {};
    if (g == 0) {
      float ta = 0.f, tb = 0.f;
#pragma unroll
      for (int w = 0; w < kMxuWarps; ++w) {
        ta += rd[w][2 * q];
        tb += rd[w][2 * q + 1];
      }
      ta = 2 * q < rows ? ta : 0.f;
      tb = 2 * q + 1 < rows ? tb : 0.f;
      if (warp == 0) {
        if (2 * q < rows) t[row0 + 2 * q] = ta;
        if (2 * q + 1 < rows) t[row0 + 2 * q + 1] = tb;
      }
      uint32_t s[NS];
      split2<NS>(ta, tb, s);
#pragma unroll
      for (int i = 0; i < NS; ++i) bt[i][0] = s[i];
    }

    // phase 2
    const bool ok0 = 2 * q < rows, ok1 = 2 * q + 1 < rows;
    const float* x0 = x + 2 * q * P + g;  // row 2q, column g
    const float* x1 = x0 + P;             // row 2q + 1
    auto chunk = [&](int64_t j0, float (&cp)[4]) {
      uint32_t a[NS][2], s[NS];
      split2<NS>(ok0 ? x0[j0] : 0.f, ok1 ? x1[j0] : 0.f, s);
#pragma unroll
      for (int i = 0; i < NS; ++i) a[i][0] = s[i];
      split2<NS>(ok0 ? x0[j0 + 8] : 0.f, ok1 ? x1[j0 + 8] : 0.f, s);
#pragma unroll
      for (int i = 0; i < NS; ++i) a[i][1] = s[i];
      mma_passes<NS>(cp, a, bt);
    };
    for (int64_t j0 = static_cast<int64_t>(warp) * 16; j0 < K; j0 += 2 * kStep) {
      const int64_t j1 = j0 + kStep;
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      chunk(j0, c0);
      if (j1 < K) chunk(j1, c1);
      if (q == 0) {
        if (j0 + g < K) p_acc[j0 + g] += c0[0];
        if (j0 + g + 8 < K) p_acc[j0 + g + 8] += c0[2];
        if (j1 + g < K) p_acc[j1 + g] += c1[0];
        if (j1 + g + 8 < K) p_acc[j1 + g + 8] += c1[2];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // both phases are done with the slot
  }

  named_barrier(kMxuBarrier, T);  // every warp's chunks of p are final
  float* out = partial + static_cast<int64_t>(blockIdx.x) * K;
  for (int64_t c = tid; c < K; c += T) out[c] = p_acc[c];
}

// ---------- planning and launch ----------

// `fixed`: the shared memory before the staging buffers; `row_bytes`: one
// staged row.
template <typename Kern>
cudaError_t plan_kernel(Kern kern, int64_t fixed, int64_t row_bytes, int max_rows, int64_t N,
                        int rows, int stages, int smem_kb, int64_t* G, int* R, int* per_sm) {
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
  while (*R >= 1 && fixed + stages * *R * row_bytes > dyn) *R /= 2;
  const int64_t tiles = *R > 0 ? (N + *R - 1) / *R : 0;
  const int64_t blocks = static_cast<int64_t>(*per_sm) * sms;
  *G = blocks < tiles ? blocks : tiles;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// kind: 0 = VPU f32 (K3), 1 = VPU bf16 (K5), 2 = mma f32 (K4).  vec: 1, or
// 4 (f32) / 8 (bf16) for 16-byte copies, which the caller may choose only
// when K % vec == 0 and X and r are 16-byte aligned.  K4 with vec 4 is
// the ring kernel `mxu_ring`, planned in Python (ops/deflate_variants.py::
// mxu_plan) from kv_mxu_limits; with vec 1 the row-staged `mxu_rows<1>`.

// Plans one row-staged variant for this shape on the current device: *R,
// the rows per staged tile (the largest power of two ≤ rows, and ≤ 8 VPU /
// 16 mma, whose `stages` buffers and the p accumulator fit the block's
// reservation of smem_kb KB, ≤ 0 for the device's maximum; 0 when not one
// row fits), *G, the blocks (rows of the partial buffer), and *per_sm, the
// blocks per SM the reservation allows.  passes: K4's (1, 3 or 6), which
// sizes r's planes; ignored for the VPU kinds.  Raises the kernel's dynamic
// shared memory limit to the device's maximum.  Returns a cudaError_t (0 =
// planned).
int kv_plan(int kind, int vec, int64_t N, int64_t K, int rows, int stages, int smem_kb,
            int passes, int64_t* G, int* R, int* per_sm) {
  if (stages != 1 && stages != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == kVpuF32 && vec == 4) {
    return plan_kernel(vpu_rows<float, 4>, smem_bytes(K, 0, 0, 4), K * 4, kVpuMaxRows, N, rows,
                       stages, smem_kb, G, R, per_sm);
  }
  if (kind == kVpuF32 && vec == 1) {
    return plan_kernel(vpu_rows<float, 1>, smem_bytes(K, 0, 0, 4), K * 4, kVpuMaxRows, N, rows,
                       stages, smem_kb, G, R, per_sm);
  }
  if (kind == kVpuBf16 && vec == 8) {
    return plan_kernel(vpu_rows<__nv_bfloat16, 8>, smem_bytes(K, 0, 0, 2), K * 2, kVpuMaxRows, N,
                       rows, stages, smem_kb, G, R, per_sm);
  }
  if (kind == kVpuBf16 && vec == 1) {
    return plan_kernel(vpu_rows<__nv_bfloat16, 1>, smem_bytes(K, 0, 0, 2), K * 2, kVpuMaxRows, N,
                       rows, stages, smem_kb, G, R, per_sm);
  }
#define KV_PLAN_MXU(NS)                                                                      \
  if (kind == kMxuF32 && vec == 1 && passes == passes_of(NS)) {                              \
    return plan_kernel(mxu_rows<NS>, mxu_fixed_bytes(K, NS), mxu_pitch(K) * 4, kMmaRows, N, rows, \
                       stages, smem_kb, G, R, per_sm);                                       \
  }
  KV_PLAN_MXU(1) KV_PLAN_MXU(2) KV_PLAN_MXU(3)
#undef KV_PLAN_MXU
  return static_cast<int>(cudaErrorInvalidValue);
}

// *budget, the bytes the dynamic shared memory of mxu_ring at `passes`
// (1, 3 or 6) may take (one block per SM), and *sms; raises its limit to
// that.  Returns a cudaError_t.
int kv_mxu_limits(int passes, int* budget, int* sms) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
#define KV_MXU_LIMITS(NS)                                                                  \
  if (passes == passes_of(NS)) {                                                         \
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, mxu_ring<NS>);              \
    if (err != cudaSuccess) return static_cast<int>(err);                                  \
    *budget = optin - static_cast<int>(attr.sharedSizeBytes);                              \
    return static_cast<int>(cudaFuncSetAttribute(                                          \
        mxu_ring<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, *budget));              \
  }
  KV_MXU_LIMITS(1) KV_MXU_LIMITS(2) KV_MXU_LIMITS(3)
#undef KV_MXU_LIMITS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the planned variant on `stream`: the tile kernel, the fixed-order
// sum of the partial rows into p, and tt: Σ tt_part (tt_inside), t·t (mma
// form, as the TPU tool takes it outside its kernel) or r·p.  passes (mma
// form only): 1, 3 or 6.  K4 with vec 4: mxu_ring with R = 8 rows a slot
// and `stages` slots (1-4); every other kind: 1 or 2 staging buffers.
// Returns cudaGetLastError() (0 = launched).
int kv_launch(int kind, int vec, const void* X, const float* r, float* t, float* p, float* tt,
              float* partial, float* tt_part, int64_t N, int64_t K, int64_t G, int R,
              int stages, int tt_inside, int passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(G);
  float* ttp = tt_inside ? tt_part : nullptr;
  const bool ring = kind == kMxuF32 && vec == 4;
  const bool stages_ok = ring ? stages >= 1 && stages <= kMxuMaxStages && R == kMxuRows
                              : stages == 1 || stages == 2;
  if (R < 1 || G < 1 || !stages_ok || (tt_inside && tt_part == nullptr)) {
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
    const float* Xf = static_cast<const float*>(X);
    const int rows = ring ? kMxuRows : R;
    bool launched = false;
#define KV_LAUNCH_MXU(NS)                                                                   \
    if (passes == passes_of(NS) && (ring || vec == 1)) {                                  \
      const size_t bytes = static_cast<size_t>(                                           \
          mxu_fixed_bytes(K, NS) + static_cast<int64_t>(stages) * rows * mxu_pitch(K) * 4); \
      if (ring) {                                                                         \
        mxu_ring<NS><<<grid, (kMxuWarps + 1) * 32, bytes, s>>>(Xf, r, t, partial, N, K, stages); \
      } else {                                                                            \
        mxu_rows<NS><<<grid, kThreads, bytes, s>>>(Xf, r, t, partial, N, K, R, stages);   \
      }                                                                                   \
      launched = true;                                                                    \
    }
    KV_LAUNCH_MXU(1) KV_LAUNCH_MXU(2) KV_LAUNCH_MXU(3)
#undef KV_LAUNCH_MXU
    if (!launched) return static_cast<int>(cudaErrorInvalidValue);
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

// The column-owning design (`cols_bf16`) in the configurations the sweep
// compares: (consumer warps, blocks per SM).
#define KV_COLS_CONFIGS(F) F(16, 1) F(8, 2)

// *budget, the bytes one configuration's ring may take, and *sms; raises its
// dynamic shared memory limit.  The plan (S, stages, G) is made in Python
// (ops/deflate.py::cols_plan).  Returns a cudaError_t.
int kv_cols_limits(int warps, int blocks, int* budget, int* sms) {
#define KV_COLS_LIMITS(W, B) \
  if (warps == W && blocks == B) return static_cast<int>(cols_limits<W, B>(budget, sms));
  KV_COLS_CONFIGS(KV_COLS_LIMITS)
#undef KV_COLS_LIMITS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the planned column-owning pass, p's fixed-order sum and tt = r·p
// on `stream`.  Returns cudaGetLastError() (0 = launched).
int kv_cols_launch(int warps, int blocks, const void* X, const float* r, float* t, float* p,
                   float* tt, float* partial, int64_t N, int64_t K, int64_t G, int S,
                   int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KV_COLS_LAUNCH(W, B)                                                              \
  if (warps == W && blocks == B) {                                                        \
    return static_cast<int>(                                                              \
        cols_launch<W, B>(X, r, t, p, tt, partial, N, K, G, S, stages, s));               \
  }
  KV_COLS_CONFIGS(KV_COLS_LAUNCH)
#undef KV_COLS_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kv_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
