// Fused deflation pass of kernel-PLS type 1 for Hopper (sm_90a).
//
// Replaces the TPU kernel `_deflate_pass_pallas` in pls_tpu/ops/deflate.py
// (bodies `_kernel_f32`, lines 83-99, and `_kernel_bf16`, lines 102-125;
// the pallas_call at lines 159-184).  For X (N, K) in float32 or bfloat16
// and r (K,) float32 it computes, in float32,
//
//     t = X r        (N,)
//     p = Xᵀ t       (K,)
//     tt = r · p     (= tᵀt, one K-length dot)
//
// What bounds it on the H100: bytes.  The pass moves N·K·itemsize bytes of
// X and does about 4·N·K flops, about 1 flop per byte in f32 and 2 in bf16,
// far below the card's ridge point (tens of flops per byte even without
// the tensor cores).  So memory bandwidth is the limit and the design goal
// is to read X from device memory once, in coalesced 16-byte loads.  The
// two-product form (t = X r, then p = Xᵀt) reads X twice.
//
// Paths, chosen per shape in Python (ops/deflate.py::choose_plan):
//  - bf16 X with K % 8 == 0, X 16-byte aligned and K ≤ 10 240: the
//    column-owning design of csrc/deflate_common.cuh (`deflate_cols<16, 1>`:
//    a producer warp's TMA ring, 16 consumer warps that own columns);
//  - otherwise, and for every f32 X (K1), the row-staged design below,
//    with 16-byte or scalar staging;
//  - K past one staged row and its p accumulator, up to 262 144 columns
//    (which holds the TPU kernel's one-pass range, K ≤ 131 072 f32,
//    ≤ 262 144 bf16): the cluster design (`deflate_cluster`, below the
//    row-staged kernels), one pass over X shared by a thread-block cluster
//    of 2-16 CTAs;
//  - K past that: the row-staged design's two-pass wide-K form.
//
// Row-staged design:
//  - A persistent grid of one block per SM.  Each block of 8 warps walks
//    a strided set of tiles of R rows.  The R rows of a tile are
//    contiguous in X, so a tile is one flat copy.
//  - Two tile buffers in shared memory: while the block reduces one tile,
//    the next streams in with asynchronous 16-byte copies (cp.async), so
//    device-memory reads stay in flight through the compute and the
//    barriers.  Each row is read from device memory once.
//  - Phase 1: the 8/R warps of each staged row reduce their share of x·r
//    in f32; tᵢ is the sum of those partials in fixed order.
//  - Phase 2: each thread owns a fixed set of columns and adds xᵢ·tᵢ of
//    the staged rows into the block's p accumulator, also in shared
//    memory (K floats).
//  - R is the largest of 8, 4, 2, 1 whose two buffers and accumulator fit
//    the block's shared memory (227 KB): R = 4 in f32 at K = 5000 (8 for
//    bf16 X, which takes this path only past K = 10 240 or when a caller
//    forces it).  One block with the largest tile beats two blocks with
//    half the tile: what counts is the bytes in flight per SM.
//  - Wider K (above about 19 000 in f32, 29 000 in bf16) does not fit even
//    one row: there the cluster design runs, and past 262 144 columns
//    two passes over X: t = X r one warp per row, and p in
//    column strips, each block adding x_i t_i of a range of rows into a
//    strip of p held in registers.
//  - 16-byte copies need K to be a multiple of the vector width (4 floats,
//    8 bf16) and X 16-byte aligned; otherwise (nir has K = 401) the same
//    kernel stages the rows with plain scalar loads and stores.  Offsets
//    are 64-bit: N·K passes 2^31 at 1M × 10k.
//  - bf16 X is widened to f32 in registers; r, t and p stay f32 between
//    the two contractions, so the only rounding is X's own.
//
// Why the cross-block reduction is two-stage and not atomic: the TPU
// kernel carries p in VMEM across a grid that runs in order; here blocks
// run in parallel in no fixed order.  Float atomics on p would make the
// sum's order, and so its last bits, change from run to run.  Instead each
// block writes its accumulator to its own row of a (G, K) f32 buffer, and
// a second kernel sums the G rows of each column in fixed order; a third,
// single-block kernel takes tt = r·p by a fixed tree (both kernels in
// csrc/deflate_common.cuh, shared with every path).  Results are
// bit-identical from run to run.
//
// Interface: plain C, loaded with ctypes (pls_tpu_torch/ops/deflate.py).
// Every launch goes on the caller's stream; nothing is allocated here.

#include <type_traits>

#include "deflate_common.cuh"

namespace {

// Dynamic shared memory of the main kernel: p accumulator, then two
// buffers of R rows.
template <typename T>
__host__ __device__ constexpr int64_t smem_bytes(int64_t K, int R) {
  return align16(K * static_cast<int64_t>(sizeof(float))) +
         2 * R * K * static_cast<int64_t>(sizeof(T));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
deflate_rows(const T* __restrict__ X, const float* __restrict__ r,
             float* __restrict__ t, float* __restrict__ partial,
             int64_t N, int64_t K, int R) {
  using Raw = typename Chunk<T, V>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_acc = reinterpret_cast<float*>(smem);  // K floats
  T* buf0 = reinterpret_cast<T*>(smem + align16(K * sizeof(float)));  // 2 × R × K
  const int64_t buf_elems = static_cast<int64_t>(R) * K;
  __shared__ float t_part[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wpr = kWarps / R;  // warps per row
  const int row = warp / wpr;  // this warp's row in the tile
  const int seg = warp % wpr;  // ... and its share of that row
  const int64_t KV = K / V;    // chunks per row (K % V == 0)

  for (int64_t c = threadIdx.x; c < K; c += kThreads) p_acc[c] = 0.f;

  const int64_t n_tiles = (N + R - 1) / R;
  auto rows_of = [&](int64_t tile_i) {
    return N - tile_i * R < R ? static_cast<int>(N - tile_i * R) : R;
  };
  if (blockIdx.x < n_tiles) {
    stage_rows<T, V>(X, buf0, static_cast<int64_t>(blockIdx.x) * R, rows_of(blockIdx.x), K);
  }
  int b = 0;
  for (int64_t tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x, b ^= 1) {
    const int64_t row0 = tile_i * R;
    const int rows = rows_of(tile_i);
    // the next tile streams in while this one is reduced
    const int64_t next = tile_i + gridDim.x;
    if (next < n_tiles) {
      stage_rows<T, V>(X, buf0 + (b ^ 1) * buf_elems, next * R, rows_of(next), K);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    __syncthreads();
    const Raw* st = reinterpret_cast<const Raw*>(buf0 + b * buf_elems);

    // phase 1: partial dots x·r of the staged rows, 8/R warps per row
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
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
    }
    if (lane == 0) t_part[warp] = acc;
    __syncthreads();

    // t of each row: its warps' partials summed in fixed order
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

    // phase 2: p += Σ_rows x_i t_i from the staged rows
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
    __syncthreads();  // this buffer and t_part are rewritten next
  }

  float* out = partial + static_cast<int64_t>(blockIdx.x) * K;
  for (int64_t c = threadIdx.x; c < K; c += kThreads) out[c] = p_acc[c];
}

// Wide K, pass 1: t_i = x_i · r, one warp per row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
row_dots(const T* __restrict__ X, const float* __restrict__ r, float* __restrict__ t,
         int64_t N, int64_t K) {
  using Raw = typename Chunk<T, V>::Raw;
  const int lane = threadIdx.x % 32;
  const int64_t KV = K / V;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32; i < N;
       i += n_warps) {
    const Raw* xi = reinterpret_cast<const Raw*>(X + i * K);
    float acc = 0.f;
#pragma unroll 4
    for (int64_t c = lane; c < KV; c += 32) {
      float x[V], rv[V];
      widen<T, V>(xi[c], x);
      load_r<V>(r + c * V, rv);
#pragma unroll
      for (int e = 0; e < V; ++e) acc = fmaf(x[e], rv[e], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) t[i] = acc;
  }
}

// Wide K, pass 2: block (s, g) adds x_i t_i of row range g, in row order,
// into column strip s (kThreads chunks of V columns) of its row g of the
// partial buffer.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
strip_partials(const T* __restrict__ X, const float* __restrict__ t,
               float* __restrict__ partial, int64_t N, int64_t K) {
  using Raw = typename Chunk<T, V>::Raw;
  const int64_t KV = K / V;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= KV) return;
  const int64_t per = (N + gridDim.y - 1) / gridDim.y;
  const int64_t i0 = blockIdx.y * per;
  const int64_t i1 = i0 + per < N ? i0 + per : N;
  float pa[V];
#pragma unroll
  for (int e = 0; e < V; ++e) pa[e] = 0.f;
#pragma unroll 4
  for (int64_t i = i0; i < i1; ++i) {
    float x[V];
    widen<T, V>(reinterpret_cast<const Raw*>(X + i * K)[c], x);
    const float ti = __ldg(t + i);
#pragma unroll
    for (int e = 0; e < V; ++e) pa[e] = fmaf(x[e], ti, pa[e]);
  }
  float* out = partial + static_cast<int64_t>(blockIdx.y) * K + c * V;
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = pa[e];
}

// Raises deflate_rows<T, V>'s dynamic shared memory limit to the device's
// maximum; *budget: the dynamic bytes it may take, *sms: the SM count.
template <typename T, int V>
cudaError_t rows_limits(int* budget, int* sms) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, deflate_rows<T, V>);
  if (err != cudaSuccess) return err;
  *budget = optin - static_cast<int>(attr.sharedSizeBytes);  // less t_part
  return cudaFuncSetAttribute(deflate_rows<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *budget);
}

// ---------- the cluster design: one pass over X at wide K ----------
//
// Replaces `_deflate_pass_pallas` (pls_tpu/ops/deflate.py:129-192) at the
// K where the TPU kernel's 16-row tile fits its 8 MiB VMEM budget
// (`pallas_supported`: K ≤ 131 072 in f32, ≤ 262 144 in bf16) but one
// staged row and the p accumulator do not fit one block's 227 KB (K past
// about 19 000 f32 / 29 000 bf16); it also takes f32 K up to 262 144,
// where the TPU kernel is two-pass.  Bytes bound it, as every path here:
// the two-pass form it replaces reads X twice.  A thread-block cluster of
// C CTAs (2, 4, 8 or 16) on neighbouring SMs shares every row instead:
//  - CTA c of a cluster owns one contiguous column slice, ceil(K/V / C)
//    chunks of V columns (the last slice ragged).  Each of its 512 threads
//    owns at most kClusterCols columns of the slice: their r and p stay in
//    registers for the whole pass, so the slices of r and p never touch
//    device memory between tiles.
//  - The CTA streams its slice of tiles of R rows (1, 2 or 4) into a ring
//    of `stages` slots (2-8): one 1-D TMA bulk copy per row slice (V > 1).
//    Where K is not a multiple of the vector width or X is not 16-byte
//    aligned (V == 1), a row slice is staged as if copied from the 16-byte
//    boundary at or below its start: its 16-byte-aligned body by one bulk
//    copy, and the few 4-byte words on each side of it (or, in a slice too
//    short for a body, all its words) by cp.async from lanes of the last
//    warp, whose completion arrives on the same `full` mbarrier.  The slot
//    of tile n - 1 is refilled with tile n - 1 + stages after tile n's
//    block barrier, when every thread of the CTA is past it, so the ring
//    needs no `empty` barrier and stages - 1 tiles stay in flight.  With
//    V == 1 the refill is issued after this CTA's partials of tᵢ are sent,
//    and its words by a warp that sends none: the peers wait on those
//    partials, and the refill's work in front of them cost about 0.1 ms
//    of a 0.5 ms pass at 10 267 × 20 531 (PERF.md §6).
//  - Each thread reduces chunks of 16 bytes of the staged slice (V
//    columns; with V == 1, 16 / sizeof(T)).  A V == 1 row lies
//    (a & 15) bytes into its slot; each shift has its own compiled loads,
//    which take a chunk's 16 bytes from two aligned blocks.
//  - tᵢ across the cluster: each CTA sums its threads' x_i[slice]·r[slice]
//    in fixed order (warp shuffles, then warp order) and stores that
//    partial into every peer's exchange buffer through distributed shared
//    memory with st.async, which completes 4 bytes of the transaction the
//    peer's exchange mbarrier expects (C·R partials a tile); every CTA
//    waits on its own mbarrier, sums the C partials in rank order, so all
//    hold the same bits of tᵢ, and rank 0 writes it.  A barrier.cluster a
//    tile instead (all threads of all CTAs, its release waiting for every
//    earlier store) was the slower design (PERF.md §6).  The exchange
//    buffer and its mbarrier are double-buffered by tile parity: a peer
//    writes a parity again only for tile n + 2, which needs tᵢ of tile
//    n + 1, which needs this CTA's partial of n + 1, sent after every
//    thread here has read tile n's.
//  - p[slice] += x_i[slice]·tᵢ from the same staged slice, so X is read
//    from device memory once; bf16 X is widened in registers.
//  - A persistent grid of G clusters (at most what
//    cudaOccupancyMaxActiveClusters allows at one CTA per SM) walks
//    strided row tiles; each CTA writes its p slice into row g of the
//    (G, K) partial buffer, which `finish_p_tt` sums in fixed order: no
//    atomics, relaunches are bit-identical.  A cluster barrier after the
//    mbarriers' set-up lets no peer store before they exist, and a last
//    one keeps every CTA alive while a peer may still address its shared
//    memory.
// Offsets are 64-bit (8 192 × 262 144 is 2³¹ elements).

constexpr int kClusterWarps = 16;
constexpr int kClusterThreads = kClusterWarps * 32;
constexpr int kClusterCols = 32;  // most columns of a slice a thread owns
constexpr int kClusterMaxRows = 4;
constexpr int kClusterMaxStages = 8;
constexpr int kClusterMax = 16;

__device__ __forceinline__ uint32_t cluster_special(int which) {
  uint32_t v = 0;
  if (which == 0) asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  if (which == 1) asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(v));
  if (which == 2) asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(v));
  if (which == 3) asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(v));
  return v;
}

// Every thread of every CTA of the cluster; release/acquire at cluster scope.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The shared::cluster address in CTA `rank` of the variable at `local`.
__device__ __forceinline__ uint32_t peer_addr(const void* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_u32(local)),
               "r"(rank));
  return remote;
}

// Stores v at `dst` in CTA `rank`'s shared memory, completing 4 bytes of
// the transaction its mbarrier at `bar` expects (both given by their
// local addresses).
__device__ __forceinline__ void st_async_peer(const float* dst, uint64_t* bar, uint32_t rank,
                                              float v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
          peer_addr(dst, rank)),
      "r"(__float_as_uint(v)), "r"(peer_addr(bar, rank))
      : "memory");
}

// mbar_wait with acquire at cluster scope: the peers' st.async data.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Bytes of one staged row slice: the slice's chunks, 16-byte aligned, and
// with scalar staging one more 16 bytes for the slice's shift from the
// 16-byte boundary its row is staged from.
__host__ __device__ constexpr int64_t cluster_row_bytes(int64_t K, int C, int V, int itemsize) {
  return align16(((K / V + C - 1) / C) * V * itemsize) + (V == 1 ? 16 : 0);
}

// Scalar staging: a row slice's words of 4 bytes go one a lane of the last
// warp, at most kClusterRowWords a row (a body's head and tail take at most
// 4 each, bf16 rows starting 2-byte aligned; a slice with no body, under
// 32 bytes, at most 8).
constexpr int kClusterRowWords = 8;
static_assert(kClusterRowWords * kClusterMaxRows == 32, "one lane of a warp a word");

// Calls f(std::integral_constant<int, B>) for the byte shift b of a staged
// row, B in [0, 16) by Step (sizeof(T)): each shift's loads compiled apart.
// b is the same for every thread of the CTA.
template <int Step, int B = 0, typename F>
__device__ __forceinline__ void with_byte_shift(int b, F&& f) {
  if constexpr (B + Step >= 16) {
    f(std::integral_constant<int, B>{});
  } else {
    if (b == B) {
      f(std::integral_constant<int, B>{});
    } else {
      with_byte_shift<Step, B + Step>(b, f);
    }
  }
}

// The 16 bytes at byte B of the staged row's 16-byte block q onwards, widened:
// block q, and for B > 0 the rest from block q + 1 (bf16 rows at B % 4 == 2
// by funnel shifts of the words).
template <typename T, int B>
__device__ __forceinline__ void load_at(const unsigned char* rowp, int q,
                                        float (&x)[16 / sizeof(T)]) {
  constexpr int W = 16 / sizeof(T);
  const uint4* blk = reinterpret_cast<const uint4*>(rowp) + q;
  const uint4 lo = blk[0];
  if constexpr (B == 0) {
    widen<T, W>(lo, x);
  } else {
    const uint4 hi = blk[1];
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    constexpr int o = B / 4;
    uint4 v;
    if constexpr (B % 4 == 0) {
      v = make_uint4(w[o], w[o + 1], w[o + 2], w[o + 3]);
    } else {
      v = make_uint4(__funnelshift_r(w[o], w[o + 1], 16),
                     __funnelshift_r(w[o + 1], w[o + 2], 16),
                     __funnelshift_r(w[o + 2], w[o + 3], 16),
                     __funnelshift_r(w[o + 3], w[o + 4], 16));
    }
    widen<T, W>(v, x);
  }
}

// How scalar staging copies the row slice of `len` bytes at `a` (the twin
// of `cluster_row_pieces` in ops/deflate.py).  The slot's row starts at
// align_down(a, 16), and each piece keeps its offset from there: the body
// [b0, b1) = [align_up(a, 16), align_down(a + len, 16)) by one bulk copy,
// `head` words from w0 = align_down(a, 4) and `tail` words from b1 by
// cp.async; with no body (b1 <= b0) all `head` words from w0.
struct RowPieces {
  uintptr_t w0, b0, b1;
  int head, tail;
};

__device__ __forceinline__ RowPieces row_pieces(uintptr_t a, int64_t len) {
  const uintptr_t e = a + static_cast<uintptr_t>(len);
  const uintptr_t w0 = a & ~uintptr_t(3), w1 = (e + 3) & ~uintptr_t(3);
  const uintptr_t b0 = (a + 15) & ~uintptr_t(15), b1 = e & ~uintptr_t(15);
  if (len == 0) return {w0, b0, b0, 0, 0};
  if (b1 <= b0) return {w0, b0, b0, static_cast<int>((w1 - w0) / 4), 0};
  return {w0, b0, b1, static_cast<int>((b0 - w0) / 4), static_cast<int>((w1 - b1) / 4)};
}

template <typename T, int V>
__global__ void __launch_bounds__(kClusterThreads, 1)
deflate_cluster(const T* __restrict__ X, const float* __restrict__ r, float* __restrict__ t,
                float* __restrict__ partial, int64_t N, int64_t K, int R, int stages) {
  using Raw = typename Chunk<T, V>::Raw;
  constexpr int W = V > 1 ? V : 16 / static_cast<int>(sizeof(T));  // columns of a chunk
  constexpr int MAXC = kClusterCols / W;  // most chunks a thread owns
  constexpr int NT = kClusterThreads;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kClusterMaxStages];
  __shared__ __align__(8) uint64_t xbar[2];  // the exchange's arrivals, by tile parity
  __shared__ float red[kClusterMaxRows][kClusterWarps];
  __shared__ float xch[2][kClusterMax][kClusterMaxRows];  // tile parity, rank, row
  const uint32_t rank = cluster_special(0);
  const int C = static_cast<int>(cluster_special(1));
  const int64_t g = cluster_special(2);
  const int64_t G = cluster_special(3);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t KV = K / V;                 // chunks of a row
  const int64_t sc_full = (KV + C - 1) / C;  // chunks of a slice
  const int64_t q0 = rank * sc_full;
  const int sc = static_cast<int>(KV - q0 < sc_full ? (KV - q0 > 0 ? KV - q0 : 0) : sc_full);
  const int64_t c0 = q0 * V;  // the slice's first column
  const int nq = V > 1 ? sc : (sc + W - 1) / W;  // its chunks (V == 1: the last may be short)
  const int cpt = (nq + NT - 1) / NT;
  const int64_t row_bytes = cluster_row_bytes(K, C, V, sizeof(T));
  const int64_t slot_bytes = row_bytes * R;
  const int64_t n_tiles = (N + R - 1) / R;

  if (tid == 0) {
    // V == 1: the cp.async arrivals of the last warp's lanes, and thread 0's for the bulk copies
    constexpr uint32_t arrivals = V > 1 ? 1 : kClusterRowWords * kClusterMaxRows + 1;
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], arrivals);
    mbar_init(&xbar[0], 1);
    mbar_init(&xbar[1], 1);
    mbar_fence_init();
  }
  cluster_sync();  // the barriers are set, and every peer has started

  // starts the copy of tile `tile`'s slice into slot `slot`
  auto fill = [&](int64_t tile, int slot) {
    const int64_t row0 = tile * R;
    const int rows = N - row0 < R ? static_cast<int>(N - row0) : R;
    unsigned char* dst = ring + slot * slot_bytes;
    if constexpr (V > 1) {
      if (tid == 0) {
        const uint32_t bytes = static_cast<uint32_t>(sc) * 16u;
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(&full[slot], bytes * rows);
        for (int i = 0; i < rows && sc > 0; ++i) {
          bulk_copy_g2s(dst + i * row_bytes, X + (row0 + i) * K + c0, bytes, &full[slot]);
        }
      }
    } else {
      const int64_t len = static_cast<int64_t>(sc) * sizeof(T);
      auto row_addr = [&](int i) {
        return reinterpret_cast<uintptr_t>(X + (row0 + i) * K + c0);
      };
      // lane i·kClusterRowWords + k of the last warp: word k of row i's head, then of its tail
      const int i = lane / kClusterRowWords, k = lane % kClusterRowWords;
      if (warp == kClusterWarps - 1 && i < rows) {
        const uintptr_t a = row_addr(i);
        const RowPieces pc = row_pieces(a, len);
        const uintptr_t w = k < pc.head ? pc.w0 + 4 * k
                            : k - pc.head < pc.tail ? pc.b1 + 4 * (k - pc.head) : 0;
        if (w) {
          cp_async4(dst + i * row_bytes + (w - (a & ~uintptr_t(15))),
                    reinterpret_cast<const void*>(w));
        }
      }
      if (warp == kClusterWarps - 1) cp_async_arrive(&full[slot]);
      if (tid == 0) {
        uint32_t tx = 0;
        for (int j = 0; j < rows; ++j) {
          const RowPieces pc = row_pieces(row_addr(j), len);
          tx += static_cast<uint32_t>(pc.b1 - pc.b0);
        }
        if (tx) {
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_expect_tx(&full[slot], tx);
          for (int j = 0; j < rows; ++j) {
            const uintptr_t a = row_addr(j);
            const RowPieces pc = row_pieces(a, len);
            if (pc.b1 > pc.b0) {
              bulk_copy_g2s(dst + j * row_bytes + (pc.b0 - (a & ~uintptr_t(15))),
                            reinterpret_cast<const void*>(pc.b0),
                            static_cast<uint32_t>(pc.b1 - pc.b0), &full[slot]);
            }
          }
        } else {
          mbar_arrive(&full[slot]);
        }
      }
    }
  };

  // this thread's chunks q = tid + j·NT of the slice: r in registers, p accumulated there
  float rv[MAXC][W], pa[MAXC][W];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int q = tid + j * NT;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const bool in = j < cpt && q < nq && (V > 1 || q * W + e < sc);
      rv[j][e] = in ? __ldg(r + c0 + static_cast<int64_t>(q) * W + e) : 0.f;
      pa[j][e] = 0.f;
    }
  }
  // chunk q of a row staged by 16-byte copies (V > 1)
  auto chunk = [&](const unsigned char* rowp, int q, auto& x) {
    widen<T, V>(*reinterpret_cast<const Raw*>(rowp + static_cast<int64_t>(q) * 16), x);
  };
  // V == 1: f(B) with B the byte shift of a staged row from its 16-byte boundary
  auto at_shift = [&](int64_t row, auto&& f) {
    const int b = static_cast<int>(reinterpret_cast<uintptr_t>(X + row * K + c0) & 15);
    with_byte_shift<static_cast<int>(sizeof(T))>(b, f);
  };
  // V == 1: acc += x_i[slice]·r[slice] of the row staged at rowp
  auto split_dot = [&](const unsigned char* rowp, int64_t row, float (&acc)[W]) {
    at_shift(row, [&](auto B) {
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int q = tid + j * NT;
        if (j < cpt && q < nq) {
          float x[W];
          load_at<T, decltype(B)::value>(rowp, q, x);
          if (q * W + W > sc) {  // a short last chunk: none of the next columns' bytes
#pragma unroll
            for (int e = 0; e < W; ++e) x[e] = q * W + e < sc ? x[e] : 0.f;
          }
#pragma unroll
          for (int e = 0; e < W; ++e) acc[e] = fmaf(x[e], rv[j][e], acc[e]);
        }
      }
    });
  };
  // V == 1: p[slice] += x_i[slice]·tᵢ of the row staged at rowp
  auto split_axpy = [&](const unsigned char* rowp, int64_t row, float ti) {
    at_shift(row, [&](auto B) {
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        const int q = tid + j * NT;
        if (j < cpt && q < nq) {
          float x[W];
          load_at<T, decltype(B)::value>(rowp, q, x);
#pragma unroll
          for (int e = 0; e < W; ++e) pa[j][e] = fmaf(x[e], ti, pa[j][e]);
        }
      }
    });
  };

  const int64_t mine = g < n_tiles ? (n_tiles - g + G - 1) / G : 0;  // this cluster's tiles
  for (int s = 0; s < stages && s < mine; ++s) fill(g + s * G, s);

  int n = 0;
  for (int64_t tile = g; tile < n_tiles; tile += G, ++n) {
    const int slot = n % stages;
    const int64_t row0 = tile * R;
    const int rows = N - row0 < R ? static_cast<int>(N - row0) : R;
    const unsigned char* st = ring + slot * slot_bytes;
    // this tile's exchange: R partials from each of the C ranks
    if (tid == 0) mbar_expect_tx(&xbar[n & 1], static_cast<uint32_t>(C * R * 4));
    mbar_wait(&full[slot], (n / stages) & 1);

    // x_i[slice]·r[slice] of the staged rows: W chains a thread, then the warp
    float d[kClusterMaxRows];
#pragma unroll
    for (int i = 0; i < kClusterMaxRows; ++i) {
      float acc[W];
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = 0.f;
      if constexpr (V == 1) {
        if (i < rows) split_dot(st + i * row_bytes, row0 + i, acc);
      } else if (i < rows) {
#pragma unroll
        for (int j = 0; j < MAXC; ++j) {
          const int q = tid + j * NT;
          if (j < cpt && q < sc) {
            float x[V];
            chunk(st + i * row_bytes, q, x);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] = fmaf(x[e], rv[j][e], acc[e]);
          }
        }
      }
      d[i] = 0.f;
#pragma unroll
      for (int e = 0; e < W; ++e) d[i] += acc[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d[i] += __shfl_xor_sync(0xffffffffu, d[i], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kClusterMaxRows; ++i) red[i][warp] = d[i];
    }
    __syncthreads();
    // every thread is past tile n - 1: its slot takes tile n - 1 + stages
    // (V == 1: once this CTA's partials are sent, below)
    auto refill = [&] {
      if (n > 0 && tile - G + static_cast<int64_t>(stages) * G < n_tiles) {
        fill(tile - G + static_cast<int64_t>(stages) * G, (n - 1) % stages);
      }
    };
    if constexpr (V > 1) refill();
    // the CTA's partial of row i, in warp order, into every peer's exchange
    // buffer: thread i·C + c stores it to rank c, completing on its xbar.
    // Every lane of a warp has read red before any lane stores: a
    // self-addressed store can complete this CTA's xbar, and a warp past
    // that wait may write red for the next tile.
    float(*xp)[kClusterMaxRows] = xch[n & 1];
    float s = 0.f;
    if (tid < R * C) {
      for (int w = 0; w < kClusterWarps; ++w) s += red[tid / C][w];
    }
    __syncwarp();
    if (tid < R * C) {
      st_async_peer(&xp[rank][tid / C], &xbar[n & 1], static_cast<uint32_t>(tid % C), s);
    }
    if constexpr (V == 1) refill();
    mbar_wait_cluster(&xbar[n & 1], (n >> 1) & 1);

    // tᵢ: the C partials in rank order; then p[slice] += x_i[slice]·tᵢ
#pragma unroll
    for (int i = 0; i < kClusterMaxRows; ++i) {
      if (i < rows) {
        float ti = 0.f;
        for (int c = 0; c < C; ++c) ti += xp[c][i];
        if (rank == 0 && tid == i) t[row0 + i] = ti;
        if constexpr (V == 1) {
          split_axpy(st + i * row_bytes, row0 + i, ti);
        } else {
#pragma unroll
          for (int j = 0; j < MAXC; ++j) {
            const int q = tid + j * NT;
            if (j < cpt && q < sc) {
              float x[V];
              chunk(st + i * row_bytes, q, x);
#pragma unroll
              for (int e = 0; e < V; ++e) pa[j][e] = fmaf(x[e], ti, pa[j][e]);
            }
          }
        }
      }
    }
  }

  float* out = partial + g * K + c0;
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int q = tid + j * NT;
    if (j < cpt && q < nq) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        if (V > 1 || q * W + e < sc) out[static_cast<int64_t>(q) * W + e] = pa[j][e];
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still address its shared memory
}

constexpr int kClusterSizes[] = {2, 4, 8, 16};

// Raises deflate_cluster<T, V>'s dynamic shared memory limit to the
// device's maximum and allows clusters of 16; *budget: the dynamic bytes
// a CTA may take; clusters[i]: the most clusters of kClusterSizes[i] CTAs
// that can be resident at once with that much shared memory (0 where that
// size cannot launch).
template <typename T, int V>
cudaError_t cluster_limits(int* budget, int* clusters) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, deflate_cluster<T, V>);
  if (err != cudaSuccess) return err;
  *budget = optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(deflate_cluster<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *budget);
  if (err != cudaSuccess) return err;
  const bool non_portable = cudaFuncSetAttribute(
      deflate_cluster<T, V>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) == cudaSuccess;
  cudaGetLastError();
  for (int i = 0; i < 4; ++i) {
    const int C = kClusterSizes[i];
    clusters[i] = 0;
    if (C > 8 && !non_portable) continue;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = C;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(*budget);
    cfg.attrs = at;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, deflate_cluster<T, V>, &cfg) == cudaSuccess) {
      clusters[i] = n;
    }
    cudaGetLastError();  // a size that cannot launch leaves 0, not a sticky error
  }
  return cudaSuccess;
}

// Launches deflate_cluster as planned (G clusters of C CTAs, tiles of R
// rows, a ring of `stages` slots), then the fixed-order sum of p and
// tt = r·p, on `stream`.  Refuses a plan the kernel cannot run.
template <typename T, int V>
cudaError_t cluster_launch(const void* X, const float* r, float* t, float* p, float* tt,
                           float* partial, int64_t N, int64_t K, int64_t G, int C, int R,
                           int stages, cudaStream_t stream) {
  const int64_t sc = (K / V + C - 1) / C;
  const bool c_ok = C == 2 || C == 4 || C == 8 || C == 16;
  if (!c_ok || R < 1 || R > kClusterMaxRows || stages < 2 || stages > kClusterMaxStages ||
      G < 1 || N < 1 || K < V * C || K % V != 0 || (sc + kClusterThreads - 1) /
      kClusterThreads > kClusterCols / V ||
      (V > 1 && reinterpret_cast<uintptr_t>(X) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem =
      static_cast<size_t>(stages) * R * cluster_row_bytes(K, C, V, static_cast<int>(sizeof(T)));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = static_cast<unsigned>(C);
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(G * C));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, deflate_cluster<T, V>, static_cast<const T*>(X), r,
                                       t, partial, N, K, R, stages);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finish_p_tt(r, p, tt, partial, G, K, stream);
}

// R > 0: the row-staged kernel over tiles of R rows; R == 0: the two-pass
// wide-K form, with G row ranges.
template <typename T, int V>
cudaError_t launch(const void* X, const float* r, float* t, float* p, float* tt, float* partial,
                   int64_t N, int64_t K, int64_t G, int R, cudaStream_t stream) {
  const T* Xt = static_cast<const T*>(X);
  if (R > 0) {
    deflate_rows<T, V><<<static_cast<unsigned>(G), kThreads,
                         static_cast<size_t>(smem_bytes<T>(K, R)), stream>>>(
        Xt, r, t, partial, N, K, R);
  } else {
    const int64_t row_blocks = (N + kWarps - 1) / kWarps;
    row_dots<T, V><<<static_cast<unsigned>(row_blocks < 4096 ? row_blocks : 4096), kThreads, 0,
                     stream>>>(Xt, r, t, N, K);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t strips = (K / V + kThreads - 1) / kThreads;
    strip_partials<T, V><<<dim3(static_cast<unsigned>(strips), static_cast<unsigned>(G)),
                           kThreads, 0, stream>>>(Xt, t, partial, N, K);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finish_p_tt(r, p, tt, partial, G, K, stream);
}

// The shipped configuration of the column-owning design (K2): 16 consumer
// warps, one block per SM (the sweep's `cols_bf16_w16_s*` rows).
constexpr int kColsWarps = 16;
constexpr int kColsBlocks = 1;

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  vec: 1, or 4 (f32) / 8 (bf16) for
// 16-byte loads, which the caller may choose only when K % vec == 0 and X
// and r are 16-byte aligned.  The plans (rows per tile, blocks, the path)
// are made in Python, ops/deflate.py.

// Limits of the current device for the pass: *staged, the dynamic shared
// memory the row-staged kernel may take; *cols, the bytes the
// column-owning kernel's ring may take (bf16 with vec 8; else 0); *sms.
// Raises both kernels' dynamic shared memory limits to the device's
// maximum.  Returns a cudaError_t (0 = done).
int pls_deflate_limits(int dtype, int vec, int* staged, int* cols, int* sms) {
  cudaError_t err = cudaErrorInvalidValue;
  *cols = 0;
  if (dtype == 0 && vec == 4) err = rows_limits<float, 4>(staged, sms);
  if (dtype == 0 && vec == 1) err = rows_limits<float, 1>(staged, sms);
  if (dtype == 1 && vec == 8) {
    err = rows_limits<__nv_bfloat16, 8>(staged, sms);
    if (err == cudaSuccess) err = cols_limits<kColsWarps, kColsBlocks>(cols, sms);
  }
  if (dtype == 1 && vec == 1) err = rows_limits<__nv_bfloat16, 1>(staged, sms);
  return static_cast<int>(err);
}

// Launches the row-staged (R > 0) or wide-K (R == 0) pass on `stream`;
// returns cudaGetLastError() (0 = launched).
int pls_deflate_pass(int dtype, int vec, const void* X, const float* r, float* t, float* p,
                     float* tt, float* partial, int64_t N, int64_t K, int64_t G, int R,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) err = launch<float, 4>(X, r, t, p, tt, partial, N, K, G, R, s);
  if (dtype == 0 && vec == 1) err = launch<float, 1>(X, r, t, p, tt, partial, N, K, G, R, s);
  if (dtype == 1 && vec == 8) {
    err = launch<__nv_bfloat16, 8>(X, r, t, p, tt, partial, N, K, G, R, s);
  }
  if (dtype == 1 && vec == 1) {
    err = launch<__nv_bfloat16, 1>(X, r, t, p, tt, partial, N, K, G, R, s);
  }
  return static_cast<int>(err);
}

// Launches the column-owning bf16 pass (G blocks, S row groups, a ring of
// `stages` slots) on `stream`; returns cudaGetLastError() (0 = launched).
int pls_deflate_cols_pass(const void* X, const float* r, float* t, float* p, float* tt,
                          float* partial, int64_t N, int64_t K, int64_t G, int S, int stages,
                          void* stream) {
  return static_cast<int>(cols_launch<kColsWarps, kColsBlocks>(
      X, r, t, p, tt, partial, N, K, G, S, stages, static_cast<cudaStream_t>(stream)));
}

// Limits of the current device for the cluster pass of (dtype, vec):
// *budget, the dynamic shared memory a cluster CTA may take; clusters[4],
// the most resident clusters of 2, 4, 8 and 16 CTAs (0: cannot launch).
// Raises the kernel's shared memory limit and allows clusters of 16.
int pls_deflate_cluster_limits(int dtype, int vec, int* budget, int* clusters) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) err = cluster_limits<float, 4>(budget, clusters);
  if (dtype == 0 && vec == 1) err = cluster_limits<float, 1>(budget, clusters);
  if (dtype == 1 && vec == 8) err = cluster_limits<__nv_bfloat16, 8>(budget, clusters);
  if (dtype == 1 && vec == 1) err = cluster_limits<__nv_bfloat16, 1>(budget, clusters);
  return static_cast<int>(err);
}

// Launches the cluster pass (G clusters of C CTAs, tiles of R rows, a ring
// of `stages` slots) on `stream`; returns cudaGetLastError() (0 = launched).
int pls_deflate_cluster_pass(int dtype, int vec, const void* X, const float* r, float* t,
                             float* p, float* tt, float* partial, int64_t N, int64_t K,
                             int64_t G, int C, int R, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4) {
    err = cluster_launch<float, 4>(X, r, t, p, tt, partial, N, K, G, C, R, stages, s);
  }
  if (dtype == 0 && vec == 1) {
    err = cluster_launch<float, 1>(X, r, t, p, tt, partial, N, K, G, C, R, stages, s);
  }
  if (dtype == 1 && vec == 8) {
    err = cluster_launch<__nv_bfloat16, 8>(X, r, t, p, tt, partial, N, K, G, C, R, stages, s);
  }
  if (dtype == 1 && vec == 1) {
    err = cluster_launch<__nv_bfloat16, 1>(X, r, t, p, tt, partial, N, K, G, C, R, stages, s);
  }
  return static_cast<int>(err);
}

const char* pls_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
