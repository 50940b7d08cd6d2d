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
//    with 16-byte or scalar staging, or its two-pass wide-K form.
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
//    one row: then two passes over X run instead, t = X r one warp per
//    row, and p in column strips, each block adding x_i t_i of a range of
//    rows into a strip of p held in registers.
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

const char* pls_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
