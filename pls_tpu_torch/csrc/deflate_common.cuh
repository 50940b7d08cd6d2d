// Pieces shared by the two deflation-pass sources for Hopper (sm_90a):
// csrc/deflate.cu (the shipped pass, K1/K2) and csrc/deflate_variants.cu
// (the sweep's variants, K3-K5).  Each source builds into its own library,
// so everything here is in an anonymous namespace and is instantiated by
// each includer.
//
//  - the 16-byte staging helpers of the row-staged designs (`Chunk`,
//    `widen`, `load_r`, `align16`, `stage_rows`);
//  - the fixed-order reductions that keep results bit-identical from
//    launch to launch: `reduce_partials` (p = Σ_g partial[g, :]) and
//    `tree_sum` (tt by a fixed tree);
//  - the column-owning design for bf16 X, `deflate_cols<W, MINB>`, with its
//    ring of TMA bulk copies and mbarriers; it is K2 on the shipped path
//    (W = 16, one block per SM) and the `cols_bf16` family of the sweep
//    (K5).
//
// The column-owning design (replaces `_kernel_bf16`, pls_tpu/ops/deflate.py
// lines 102-125, and `make_vpu_bf16`, tools/kernel_variants.py lines
// 208-272).  For X (N, K) bf16 and r (K,) f32 it computes t = X r with X
// widened to f32 and f32 sums, p = Xᵀt with t kept in f32, and tt = r·p.
// What bounds it on the H100: bytes, N·K·2 of X over 3.35 TB/s (about 2
// flops per byte).  The row-staged design (`deflate_rows` / `vpu_rows` on
// bf16) ran at under half of that bound: its time followed the elements,
// not the bytes, because each lane's dot was one dependent FMA chain, each
// staged element was read from shared memory and widened twice, r was
// re-read for every staged row, p went through shared memory on every tile,
// and eight warps met at three block-wide barriers per tile.  Here:
//  - MINB blocks per SM (1, or 2 at W = 8), each of W consumer warps and
//    one producer warp.  The producer's one thread keeps a ring of
//    `stages` tiles (2-8) in flight with 1-D TMA bulk copies
//    (cp.async.bulk ... complete_tx), one `full` mbarrier per slot; a tile
//    of R rows is contiguous in X, so it is one copy and needs no tensor
//    map.  Each consumer warp arrives on the slot's `empty` mbarrier as
//    soon as its values are in registers.
//  - Columns owned for the whole pass.  The consumer threads form S row
//    groups of 32·W/S threads; a tile has R = 2·S rows, two per group.  A
//    thread owns the 4-column chunks lt, lt + 32·W/S, ... (at most 5) of
//    its group: it loads its slice of r into registers once and keeps its
//    slice of p in registers to the end.
//  - Each staged element is read from shared memory once (8-byte loads)
//    and kept packed in registers; the two rows' partial dots are eight
//    independent FMA chains.  Chunks past the busiest thread's count are
//    skipped by a uniform branch, not computed on zeros.
//  - One small barrier per tile: the partial dots are summed by warp
//    shuffles and a small double-buffered shared array, behind one named
//    barrier (`bar.sync 1`) of the consumer warps only; every thread of a
//    group then sums the same partials in the same order (float4 reads),
//    so tᵢ is known to all of them without a broadcast.
//  - The mapping: the plan (ops/deflate.py::cols_plan) picks S from 1, 2,
//    4, 8 so that the chunks spread as evenly as possible over a group's
//    threads, then the largest S.  At W = 16: K = 5000 (1250 chunks) takes
//    S = 2 (256 threads, 5 chunks each, 97.7 % of the slots used, 4-row
//    tiles of 40 KB); K = 2048 (512 chunks) takes S = 4 (128 threads, 4
//    chunks each, 100 %, 8-row tiles of 32 KB).  K above 32·W·5·4 (10 240
//    at W = 16) does not fit the registers: the row-staged path takes it.
//    W = 16 is shipped: at 100k×5k it ran 1.5× faster than W = 12 (S = 1,
//    4 chunks a thread, 81 % of the slots) and 8 % faster than two blocks
//    of 8 warps (PERF.md §6).  16 consumer warps and the producer
//    leave 96 registers a thread; the kernel fits them without spills.
//  - The groups' p are summed in group order at the end (over the ring's
//    shared memory) and each block writes one row of the (G, K) partial
//    buffer; `reduce_partials` sums the rows in fixed order.  Relaunches
//    are bit-identical.  The ragged last tile is copied short and its
//    missing rows are masked.  Row offsets are 64-bit, offsets inside a
//    tile 32-bit.  Needs K % 8 == 0 and X 16-byte aligned (the bulk copy's
//    rule); r is read with scalar loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps of the row-staged designs' blocks
constexpr int kThreads = kWarps * 32;
constexpr int kReduceThreads = 256;
constexpr int kSumThreads = 1024;

// ---------- row-staged helpers ----------

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

// Starts the copy of rows [row0, row0 + rows) of X, which are contiguous,
// into `buf` with the block's kThreads threads: asynchronous 16-byte copies
// (cp.async) when V > 1, plain loads and stores otherwise.  Commits one
// pipeline group either way.
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

// p from the (G, K) partial buffer, then tt = r·p, on `stream`.
inline cudaError_t finish_p_tt(const float* r, float* p, float* tt, const float* partial,
                               int64_t G, int64_t K, cudaStream_t stream) {
  const int64_t reduce_blocks = (K + kReduceThreads - 1) / kReduceThreads;
  reduce_partials<<<static_cast<unsigned>(reduce_blocks), kReduceThreads, 0, stream>>>(
      partial, p, G, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tree_sum<<<1, kSumThreads, 0, stream>>>(r, p, tt, K);
  return cudaGetLastError();
}

// ---------- the column-owning design for bf16 X ----------

constexpr int kColsRows = 2;       // rows of each tile a consumer thread reduces
constexpr int kColsChunks = 5;     // most 4-column chunks a consumer thread owns
constexpr int kColsMaxGroups = 8;  // row groups S; a tile has kColsRows·S rows
constexpr int kColsMaxStages = 8;  // slots of the ring
constexpr int kColsBarrier = 1;    // named barrier of the consumer warps (0 is __syncthreads)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised mbarriers visible to the other threads and to the
// bulk copies (the async proxy).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// The producer's arrival on a `full` barrier, announcing the bytes that the
// slot's bulk copy will complete.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.  A fresh
// barrier counts its phase "before 0" (parity 1) as completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Four bf16 (two packed pairs, the lower index in the low half) as floats.
__device__ __forceinline__ void widen4(uint2 raw, float (&x)[4]) {
  x[0] = __uint_as_float(raw.x << 16);
  x[1] = __uint_as_float(raw.x & 0xffff0000u);
  x[2] = __uint_as_float(raw.y << 16);
  x[3] = __uint_as_float(raw.y & 0xffff0000u);
}

// Block b reduces tiles b, b + G, ... of R = kColsRows·S rows; writes t of
// its rows and its row b of `partial`.  W consumer warps and one producer
// warp; MINB blocks per SM.
template <int W, int MINB>
__global__ void __launch_bounds__((W + 1) * 32, MINB)
deflate_cols(const __nv_bfloat16* __restrict__ X, const float* __restrict__ r,
             float* __restrict__ t, float* __restrict__ partial, int64_t N, int64_t K, int S,
             int stages) {
  constexpr int T = W * 32;            // consumer threads
  constexpr int RG = kColsRows;
  constexpr int WP = (W + 3) / 4 * 4;  // a row of warp partials, padded to float4s
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kColsMaxStages];
  __shared__ __align__(8) uint64_t empty[kColsMaxStages];
  __shared__ __align__(16) float red[2][RG * kColsMaxGroups][WP];  // tile parity, row, warp
  const int R = RG * S;
  const int Ki = static_cast<int>(K);  // K ≤ 32·W·kColsChunks·4 on this path
  const int tile_bytes = R * Ki * 2;
  const int64_t n_tiles = (N + R - 1) / R;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= T) {  // the producer warp: one thread keeps the ring full
    if (tid == T) {
      int n = 0;
      for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++n) {
        const int slot = n % stages;
        mbar_wait(&empty[slot], ((n / stages) & 1) ^ 1);
        const int64_t row0 = tile * R;
        const int64_t rows = N - row0 < R ? N - row0 : R;
        const uint32_t bytes = static_cast<uint32_t>(rows * K * 2);
        mbar_expect_tx(&full[slot], bytes);
        bulk_copy_g2s(ring + slot * tile_bytes, X + row0 * K, bytes, &full[slot]);
      }
    }
    return;
  }

  const int TG = T / S;  // threads of a row group
  const int grp = tid / TG;
  const int lt = tid - grp * TG;
  const int lane = tid % 32;
  const int wg = lt / 32;  // warp within the group
  const int WG = TG / 32;
  const int KC = Ki / 4;               // 4-column chunks of a row
  const int cpt = (KC + TG - 1) / TG;  // chunks of the busiest thread (uniform)
  const int lane_off = (grp * RG * Ki + lt * 4) * 2;  // this thread's first chunk in a tile

  bool own[kColsChunks];
  float rv[kColsChunks][4], pa[kColsChunks][4];
#pragma unroll
  for (int j = 0; j < kColsChunks; ++j) {
    const int c = lt + j * TG;
    own[j] = c < KC;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rv[j][e] = own[j] ? __ldg(r + 4 * c + e) : 0.f;
      pa[j][e] = 0.f;
    }
  }

  int n = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++n) {
    const int slot = n % stages;
    const int rows = N - tile * R < R ? static_cast<int>(N - tile * R) : R;
    mbar_wait(&full[slot], (n / stages) & 1);

    // this thread's chunks of its group's RG rows: one shared-memory read
    // each, kept packed; the partial dots in 4·RG independent chains
    const unsigned char* base = ring + slot * tile_bytes + lane_off;
    uint2 xv[RG][kColsChunks];
    float acc[RG][4];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const bool live = grp * RG + i < rows;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < kColsChunks; ++j) {
        if (j < cpt) {
          xv[i][j] = (own[j] && live)
                         ? *reinterpret_cast<const uint2*>(base + (i * Ki + j * TG * 4) * 2)
                         : make_uint2(0u, 0u);
          float x[4];
          widen4(xv[i][j], x);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(x[e], rv[j][e], acc[i][e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // the warp's values are in registers

    float d[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) d[i] = (acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < RG; ++i) d[i] += __shfl_xor_sync(0xffffffffu, d[i], off);
    }
    float(*rd)[WP] = red[n & 1];
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RG; ++i) rd[grp * RG + i][wg] = d[i];
    }
    named_barrier(kColsBarrier, T);

    // tᵢ: the group's warp partials in warp order, the same sum in every
    // thread of the group; then p += xᵢ tᵢ on the owned chunks
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int row = grp * RG + i;
      float ti = 0.f;
#pragma unroll
      for (int w4 = 0; w4 < WP; w4 += 4) {
        if (w4 < WG) {
          const float4 v = *reinterpret_cast<const float4*>(&rd[row][w4]);
          ti += v.x;
          if (w4 + 1 < WG) ti += v.y;
          if (w4 + 2 < WG) ti += v.z;
          if (w4 + 3 < WG) ti += v.w;
        }
      }
      if (row < rows) {
        if (lt == i) t[tile * R + row] = ti;
#pragma unroll
        for (int j = 0; j < kColsChunks; ++j) {
          if (j < cpt && own[j]) {
            float x[4];
            widen4(xv[i][j], x);
#pragma unroll
            for (int e = 0; e < 4; ++e) pa[j][e] = fmaf(x[e], ti, pa[j][e]);
          }
        }
      }
    }
  }

  // the groups' p, summed in group order over the ring (all its copies
  // have landed and been read), into the block's row of `partial`
  float* out = partial + static_cast<int64_t>(blockIdx.x) * K;
  float* scratch = reinterpret_cast<float*>(ring);  // (S - 1) × K floats
  if (S > 1) {
    named_barrier(kColsBarrier, T);
    if (grp > 0) {
#pragma unroll
      for (int j = 0; j < kColsChunks; ++j) {
        if (own[j]) {
          const int c = lt + j * TG;
          *reinterpret_cast<float4*>(scratch + (grp - 1) * Ki + 4 * c) =
              make_float4(pa[j][0], pa[j][1], pa[j][2], pa[j][3]);
        }
      }
    }
    named_barrier(kColsBarrier, T);
  }
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < kColsChunks; ++j) {
      if (own[j]) {
        const int c = lt + j * TG;
        float s[4] = {pa[j][0], pa[j][1], pa[j][2], pa[j][3]};
        for (int g = 1; g < S; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(scratch + (g - 1) * Ki + 4 * c);
          s[0] += v.x;
          s[1] += v.y;
          s[2] += v.z;
          s[3] += v.w;
        }
        *reinterpret_cast<float4*>(out + 4 * c) = make_float4(s[0], s[1], s[2], s[3]);
      }
    }
  }
}

// Raises deflate_cols' dynamic shared memory limit to what MINB blocks per
// SM allow; *budget: the bytes the ring may take, *sms: the SM count.
template <int W, int MINB>
cudaError_t cols_limits(int* budget, int* sms) {
  int dev = 0, optin = 0, sm_smem = 0, reserved = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, deflate_cols<W, MINB>);
  if (err != cudaSuccess) return err;
  const int per_block = sm_smem / MINB - reserved < optin ? sm_smem / MINB - reserved : optin;
  *budget = per_block - static_cast<int>(attr.sharedSizeBytes);
  return cudaFuncSetAttribute(deflate_cols<W, MINB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, *budget);
}

// Launches deflate_cols as planned (G blocks, S row groups, a ring of
// `stages` slots), then the fixed-order sum of p and tt = r·p, on `stream`.
// Refuses a plan the kernel cannot run.
template <int W, int MINB>
cudaError_t cols_launch(const void* X, const float* r, float* t, float* p, float* tt,
                        float* partial, int64_t N, int64_t K, int64_t G, int S, int stages,
                        cudaStream_t stream) {
  constexpr int T = W * 32;
  const bool s_ok = S >= 1 && S <= kColsMaxGroups && T % S == 0 && (T / S) % 32 == 0;
  if (!s_ok || stages < 2 || stages > kColsMaxStages || G < 1 || N < 1 || K < 8 || K % 8 != 0 ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0 ||
      (K / 4 + T / S - 1) / (T / S) > kColsChunks) {
    return cudaErrorInvalidValue;
  }
  const size_t ring_bytes = static_cast<size_t>(stages) * kColsRows * S * K * 2;
  deflate_cols<W, MINB><<<static_cast<unsigned>(G), T + 32, ring_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(X), r, t, partial, N, K, S, stages);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finish_p_tt(r, p, tt, partial, G, K, stream);
}

}  // namespace
