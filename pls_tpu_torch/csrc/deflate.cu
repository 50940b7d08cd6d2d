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
// Design:
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
//    the block's shared memory (227 KB): R = 4 in f32 and 8 in bf16 at
//    K = 5000.  One block with the largest tile beats two blocks with half
//    the tile: what counts is the bytes in flight per SM.
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
// single-block kernel takes tt = r·p by a fixed tree.  Results are
// bit-identical from run to run.
//
// Interface: plain C, loaded with ctypes (pls_tpu_torch/ops/deflate.py).
// Every launch goes on the caller's stream; nothing is allocated here.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kReduceThreads = 256;
constexpr int kDotThreads = 1024;

// V consecutive elements of X as one load: 16 bytes when V > 1.
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

// V consecutive floats of r (16-byte aligned when V > 1).
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

// Dynamic shared memory of the main kernel: p accumulator, then two
// buffers of R rows.
template <typename T>
__host__ __device__ constexpr int64_t smem_bytes(int64_t K, int R) {
  return align16(K * static_cast<int64_t>(sizeof(float))) +
         2 * R * K * static_cast<int64_t>(sizeof(T));
}

// Starts the copy of rows [row0, row0 + rows) of X, which are contiguous,
// into `buf`: asynchronous 16-byte copies (cp.async) when V > 1, plain
// loads and stores otherwise.  Commits one pipeline group either way.
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

// p[j] = Σ_g partial[g, j], g in increasing order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const float* __restrict__ partial, float* __restrict__ p,
                int64_t G, int64_t K) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  if (j >= K) return;
  float s = 0.f;
  for (int64_t g = 0; g < G; ++g) s += partial[g * K + j];
  p[j] = s;
}

// tt = r · p in one block, by a fixed tree.
__global__ void __launch_bounds__(kDotThreads)
dot_rp(const float* __restrict__ r, const float* __restrict__ p,
       float* __restrict__ tt, int64_t K) {
  __shared__ float red[kDotThreads];
  float s = 0.f;
  for (int64_t j = threadIdx.x; j < K; j += kDotThreads) s = fmaf(r[j], p[j], s);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kDotThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) tt[0] = red[0];
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

// Plans the pass for one shape, once: R, the rows per staged tile (the
// largest of kWarps, ..., 2, 1 whose two buffers and accumulator fit one
// block's shared memory; 0 when not even one row fits, and the two-pass
// wide-K path runs), and G, the blocks that write the partial buffer (its
// rows).  Raises the staged kernel's dynamic shared memory limit to the
// device's maximum, so that every planned shape can launch.
template <typename T, int V>
cudaError_t plan(int64_t N, int64_t K, int64_t* G, int* R) {
  int dev = 0, optin = 0, sms = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, deflate_rows<T, V>);
  if (err != cudaSuccess) return err;
  const int budget = optin - static_cast<int>(attr.sharedSizeBytes);  // less t_part
  err = cudaFuncSetAttribute(deflate_rows<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             budget);
  if (err != cudaSuccess) return err;
  *R = kWarps;
  while (*R >= 1 && smem_bytes<T>(K, *R) > budget) *R /= 2;
  if (*R > 0) {  // one block per SM, or one per tile when there are fewer tiles
    const int64_t tiles = (N + *R - 1) / *R;
    *G = sms < tiles ? sms : tiles;
  } else {  // about 4 blocks per SM over strips × row ranges
    const int64_t strips = (K / V + kThreads - 1) / kThreads;
    const int64_t g = (4 * static_cast<int64_t>(sms) + strips - 1) / strips;
    *G = g < N ? g : N;
  }
  return cudaSuccess;
}

template <typename T, int V>
int launch(const void* X, const float* r, float* t, float* p, float* tt, float* partial,
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
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t strips = (K / V + kThreads - 1) / kThreads;
    strip_partials<T, V><<<dim3(static_cast<unsigned>(strips), static_cast<unsigned>(G)),
                           kThreads, 0, stream>>>(Xt, t, partial, N, K);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t reduce_blocks = (K + kReduceThreads - 1) / kReduceThreads;
  reduce_partials<<<static_cast<unsigned>(reduce_blocks), kReduceThreads, 0, stream>>>(
      partial, p, G, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_rp<<<1, kDotThreads, 0, stream>>>(r, p, tt, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  vec: 1, or 4 (f32) / 8 (bf16) for
// 16-byte loads, which the caller may choose only when K % vec == 0 and X
// and r are 16-byte aligned.

// Plans the pass for this shape on the current device: *G, the rows of the
// partial buffer, and *R, the rows per staged tile (0: the wide-K path).
// Returns a cudaError_t (0 = planned).
int pls_deflate_plan(int dtype, int vec, int64_t N, int64_t K, int64_t* G, int* R) {
  if (dtype == 0 && vec == 4) return static_cast<int>(plan<float, 4>(N, K, G, R));
  if (dtype == 0 && vec == 1) return static_cast<int>(plan<float, 1>(N, K, G, R));
  if (dtype == 1 && vec == 8) return static_cast<int>(plan<__nv_bfloat16, 8>(N, K, G, R));
  if (dtype == 1 && vec == 1) return static_cast<int>(plan<__nv_bfloat16, 1>(N, K, G, R));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches the planned pass on `stream`; returns cudaGetLastError() (0 =
// launched).
int pls_deflate_pass(int dtype, int vec, const void* X, const float* r, float* t, float* p,
                     float* tt, float* partial, int64_t N, int64_t K, int64_t G, int R,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return launch<float, 4>(X, r, t, p, tt, partial, N, K, G, R, s);
  if (dtype == 0 && vec == 1) return launch<float, 1>(X, r, t, p, tt, partial, N, K, G, R, s);
  if (dtype == 1 && vec == 8) {
    return launch<__nv_bfloat16, 8>(X, r, t, p, tt, partial, N, K, G, R, s);
  }
  if (dtype == 1 && vec == 1) {
    return launch<__nv_bfloat16, 1>(X, r, t, p, tt, partial, N, K, G, R, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pls_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
