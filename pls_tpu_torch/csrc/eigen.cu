// Dominant eigenvector of a batch of small symmetric matrices for Hopper
// (sm_90a): cyclic Jacobi in float64, one warp a matrix.
//
// Replaces `torch.linalg.eigh` in pls_tpu_torch/ops/eigen.py on the card
// (the TPU side calls `jnp.linalg.eigh` in pls_tpu/ops/eigen.py; no Pallas
// kernel).  The fit loop asks for the dominant eigenvector of XYᵀXY, an
// M×M matrix with M the number of responses, once a component.  cuSOLVER's
// syevd reads its `info` back to the host, so every call drained the
// stream and the card sat idle while the host issued the next component.
// This kernel reads nothing back.
//
// What bounds it: latency.  An M×M problem with M ≤ 32 is a few kB; the
// time is the chain of dependent rounds, each five float64 divisions and
// square roots in a row and one pass over the matrix in shared memory.
//
// Design, one warp a matrix (kWarps matrices a block, for the batched fold
// calls):
//  - C (M×M, float32 or float64) is read into shared memory as float64,
//    padded with a zero row and column to an even order m, and scaled by
//    a power of two (exact) so that its largest entry lies in [0.5, 1):
//    the sums of squares below neither overflow nor underflow.  V = I.
//  - Cyclic Jacobi with the parallel round-robin ordering (Brent & Luk,
//    1985): m/2 disjoint pairs a round, m − 1 rounds a sweep, every pair
//    once a sweep.  Round r pairs (r, m − 1) and ((r + k), (r − k)) mod
//    (m − 1) for k = 1 … m/2 − 1; the padding index m − 1 of odd M pairs
//    with a zero row and its rotation is the identity.
//  - A round: lane k < m/2 takes the angle of pair k by Rutishauser's
//    formulas (θ = (a_qq − a_pp)/(2a_pq), t = sgn θ/(|θ| + √(θ² + 1)),
//    t = 0 where a_pq = 0; c = 1/√(t² + 1), s = t·c, τ = s/(1 + c), taken
//    as s = t/u and τ = t/(u + 1) with u = √(t² + 1), so that the two
//    divisions run side by side) and writes the pair's own 2×2 block
//    (a_pp − t·a_pq, a_qq + t·a_pq, 0).  Then the lanes, the last first,
//    rotate whole 2×2 blocks of A (pair a × pair b, a < b: rows by a's
//    rotation, then columns by b's, x' = x − s(y + τx), y' = y + s(x − τy))
//    and write each block and its transpose, so A stays exactly symmetric;
//    and, the first lane first, V by the round's pairs (V ← V·P), two
//    entries of a row at a time.  Blocks and V's entries are disjoint, so
//    both update in place, with one __syncwarp after the angles and one
//    after the updates.  (Lanes past m/2 taking V's update during the next
//    round's angles saved nothing: the two paths ran one after the other.)
//    The rounds' pairs come from additions alone; the blocks' (a, b) from
//    a table made once.
//  - Stop, checked before every sweep: the off-diagonal sum of squares
//    ≤ (2⁻⁵²)²·‖C‖²_F (both of the scaled matrix), or kMaxSweeps sweeps.
//    Every sum is taken in a fixed order: lane l adds the entries
//    l, l + 32, … of the row-major M×M matrix, then a butterfly of xor
//    shuffles.  Every operation is an IEEE round-to-nearest intrinsic
//    (__dmul_rn, __dadd_rn, __ddiv_rn, __drcp_rn, __dsqrt_rn: no fused
//    multiply-add),
//    so `jacobi_dominant_plain` in ops/eigen.py repeats it bit for bit.
//  - Result: the column of V of the largest diagonal entry (the lowest
//    index on a tie), with the sign that makes its entry of largest
//    magnitude positive (the lowest index on a tie), in C's dtype.  A C
//    with a non-finite entry gives NaN.
//
// Interface: plain C, loaded with ctypes (pls_tpu_torch/ops/eigen.py).
// Launches go on the caller's stream; nothing is allocated here.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxM = 32;
constexpr int kWarps = 4;  // matrices a block
constexpr int kMaxSweeps = 20;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int even_order(int M) { return M + (M & 1); }

__host__ __device__ constexpr int block_count(int M) {
  return even_order(M) / 2 * (even_order(M) / 2 - 1) / 2;
}

// doubles of shared memory a warp takes: A (m × ld), V (m × ld), the m/2
// pairs' s and τ, then the blocks' (a, b) as bytes
__host__ __device__ constexpr int warp_doubles(int M) {
  return even_order(M) * (2 * (even_order(M) + 1) + 1) + (2 * block_count(M) + 7) / 8;
}

// pair k of round r: (r, m − 1) for k = 0, else ((r + k), (r − k)) mod (m − 1)
__device__ __forceinline__ void pair_of(int r, int k, int m, int& p, int& q) {
  int a = r, b = m - 1;
  if (k > 0) {
    a = r + k;
    if (a >= m - 1) a -= m - 1;
    b = r - k;
    if (b < 0) b += m - 1;
  }
  p = min(a, b);
  q = max(a, b);
}

// x' = x − s(y + τx), y' = y + s(x − τy): the rotation c·x − s·y,
// s·x + c·y in Rutishauser's form
__device__ __forceinline__ void rotate(double& x, double& y, double s, double tau) {
  const double x0 = x;
  x = __dsub_rn(x0, __dmul_rn(s, __dadd_rn(y, __dmul_rn(tau, x0))));
  y = __dadd_rn(y, __dmul_rn(s, __dsub_rn(x0, __dmul_rn(tau, y))));
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Σ a_ij² over the M×M matrix (off: i ≠ j only), in the fixed order above;
// this lane's first entry is (i, j), and 32 entries on is (di, dj) further
__device__ double sum_squares(const double* A, int M, int ld, int lane, bool off, int i, int j,
                              int di, int dj) {
  double s = 0.0;
  for (int e = lane; e < M * M; e += 32) {
    if (!off || i != j) {
      const double x = A[i * ld + j];
      s = __dadd_rn(s, __dmul_rn(x, x));
    }
    i += di;
    j += dj;
    if (j >= M) {
      j -= M;
      ++i;
    }
  }
  return warp_sum(s);
}

// V ← V·P for the rotations of round r (s of pair a at sv[a], τ at
// sv[h + a]): the entries (i, p_a), (i, q_a) of the items v = lane,
// lane + 32, … < M·h (i = v / h, a = v mod h), two items at a time
__device__ void rotate_v(double* V, const double* sv, int r, int m, int M, int ld, int lane) {
  const int h = m / 2, n = M * h, step = 32, di = step / h, da = step - di * h;
  int i = lane / h, a = lane - i * h;
  for (int v = lane; v < n; v += 2 * step) {
    int i2 = i + di, a2 = a + da;
    if (a2 >= h) {
      a2 -= h;
      ++i2;
    }
    const bool two = v + step < n;
    int p1, q1, p2, q2;
    pair_of(r, a, m, p1, q1);
    pair_of(r, a2, m, p2, q2);
    double x1 = V[i * ld + p1], y1 = V[i * ld + q1], x2 = 0.0, y2 = 0.0;
    if (two) {
      x2 = V[i2 * ld + p2];
      y2 = V[i2 * ld + q2];
    }
    rotate(x1, y1, sv[a], sv[h + a]);
    V[i * ld + p1] = x1;
    V[i * ld + q1] = y1;
    if (two) {
      rotate(x2, y2, sv[a2], sv[h + a2]);
      V[i2 * ld + p2] = x2;
      V[i2 * ld + q2] = y2;
    }
    i = i2 + di;
    a = a2 + da;
    if (a >= h) {
      a -= h;
      ++i;
    }
  }
}

// index of the largest value over the warp, the lowest index on a tie
__device__ __forceinline__ int warp_argmax(double v, int i) {
  for (int o = 16; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  return i;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
jacobi_dominant(const T* __restrict__ C, T* __restrict__ out, int64_t B, int M) {
  extern __shared__ double smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;
  const int m = even_order(M), h = m / 2, ld = m + 1, blocks = block_count(M);
  double* A = smem + warp * warp_doubles(M);
  double* V = A + m * ld;
  double* sv = V + m * ld;  // s of pair k at sv[k], τ at sv[h + k]
  unsigned char* ab = reinterpret_cast<unsigned char*>(sv + m);  // block k: ab[2k], ab[2k+1]
  const T* Cb = C + b * M * M;
  T* ob = out + b * M;

  // the blocks (a, b), a < b, row by row
  for (int k = lane; k < blocks; k += 32) {
    int a = 0, rest = k;
    while (rest >= h - 1 - a) {
      rest -= h - 1 - a;
      ++a;
    }
    ab[2 * k] = static_cast<unsigned char>(a);
    ab[2 * k + 1] = static_cast<unsigned char>(a + 1 + rest);
  }
  double amax = 0.0;
  bool finite = true;
  for (int e = lane; e < m * m; e += 32) {
    const int i = e / m, j = e - i * m;
    const double x = (i < M && j < M) ? static_cast<double>(Cb[i * M + j]) : 0.0;
    finite = finite && isfinite(x);
    amax = fmax(amax, fabs(x));
    A[i * ld + j] = x;
    V[i * ld + j] = i == j ? 1.0 : 0.0;
  }
  if (!__all_sync(kFull, finite)) {
    if (lane < M) ob[lane] = static_cast<T>(NAN);
    return;
  }
  for (int o = 16; o > 0; o >>= 1) amax = fmax(amax, __shfl_xor_sync(kFull, amax, o));
  // this lane's first entry of the M×M matrix in the sums, and the step
  const int si = lane / M, sj = lane - si * M, sdi = 32 / M, sdj = 32 - sdi * M;
  __syncwarp();
  if (amax > 0.0) {
    int ex;
    frexp(amax, &ex);
    const double scale = ldexp(1.0, -min(max(ex, -1023), 1022));
    for (int e = lane; e < M * M; e += 32) {
      const int i = e / M, j = e - i * M;
      A[i * ld + j] = __dmul_rn(A[i * ld + j], scale);
    }
  }
  __syncwarp();

  const double tol =
      __dmul_rn(sum_squares(A, M, ld, lane, false, si, sj, sdi, sdj), 0x1p-104);
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    if (sum_squares(A, M, ld, lane, true, si, sj, sdi, sdj) <= tol) break;
    for (int r = 0; r < m - 1; ++r) {
      if (lane < h) {
        int p, q;
        pair_of(r, lane, m, p, q);
        const double app = A[p * ld + p], aqq = A[q * ld + q], apq = A[p * ld + q];
        // a_pq = 0 makes θ infinite or NaN; t is then 0, picked without a branch
        const double theta = __ddiv_rn(__dsub_rn(aqq, app), __dmul_rn(2.0, apq));
        const double root = __dsqrt_rn(__dadd_rn(__dmul_rn(theta, theta), 1.0));
        double t = __drcp_rn(__dadd_rn(fabs(theta), root));
        if (theta < 0.0) t = -t;
        if (apq == 0.0) t = 0.0;
        // u = 1/c: s = t·c = t/u, τ = s/(1 + c) = t/(u + 1)
        const double u = __dsqrt_rn(__dadd_rn(__dmul_rn(t, t), 1.0));
        sv[lane] = __ddiv_rn(t, u);
        sv[h + lane] = __ddiv_rn(t, __dadd_rn(u, 1.0));
        const double tapq = __dmul_rn(t, apq);
        A[p * ld + p] = __dsub_rn(app, tapq);
        A[q * ld + q] = __dadd_rn(aqq, tapq);
        A[p * ld + q] = 0.0;
        A[q * ld + p] = 0.0;
      }
      __syncwarp();
      // the blocks from the last lane down, then V's items from the first
      for (int k = 31 - lane; k < blocks; k += 32) {
        const int a = ab[2 * k], bb = ab[2 * k + 1];
        int p1, q1, p2, q2;
        pair_of(r, a, m, p1, q1);
        pair_of(r, bb, m, p2, q2);
        double x00 = A[p1 * ld + p2], x01 = A[p1 * ld + q2];
        double x10 = A[q1 * ld + p2], x11 = A[q1 * ld + q2];
        const double sa = sv[a], ta = sv[h + a], sb = sv[bb], tb = sv[h + bb];
        rotate(x00, x10, sa, ta);
        rotate(x01, x11, sa, ta);
        rotate(x00, x01, sb, tb);
        rotate(x10, x11, sb, tb);
        A[p1 * ld + p2] = x00;
        A[p1 * ld + q2] = x01;
        A[q1 * ld + p2] = x10;
        A[q1 * ld + q2] = x11;
        A[p2 * ld + p1] = x00;
        A[q2 * ld + p1] = x01;
        A[p2 * ld + q1] = x10;
        A[q2 * ld + q1] = x11;
      }
      rotate_v(V, sv, r, m, M, ld, lane);
      __syncwarp();
    }
  }

  const int j = warp_argmax(lane < M ? A[lane * ld + lane] : -INFINITY, lane);
  const double v = lane < M ? V[lane * ld + j] : 0.0;
  const int big = warp_argmax(lane < M ? fabs(v) : -1.0, lane);
  const bool flip = __shfl_sync(kFull, v, big) < 0.0;
  if (lane < M) ob[lane] = static_cast<T>(flip ? -v : v);
}

template <typename T>
cudaError_t prepare() {
  return cudaFuncSetAttribute(jacobi_dominant<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kWarps * warp_doubles(kMaxM) * static_cast<int>(sizeof(double)));
}

template <typename T>
cudaError_t launch(const void* C, void* out, int64_t B, int M, cudaStream_t stream) {
  const int64_t grid = (B + kWarps - 1) / kWarps;
  const size_t smem = kWarps * warp_doubles(M) * sizeof(double);
  jacobi_dominant<T><<<static_cast<unsigned>(grid), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(C), static_cast<T*>(out), B, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Raises both kernels' dynamic shared memory limit on the current device
// to what M = 32 takes.  Returns a cudaError_t (0 = done).
int pls_eigen_prepare() {
  cudaError_t err = prepare<float>();
  if (err == cudaSuccess) err = prepare<double>();
  return static_cast<int>(err);
}

// Launches the dominant eigenvectors of C (B, M, M) into out (B, M),
// float32 (dtype 0) or float64 (dtype 1), on `stream`; returns
// cudaGetLastError() (0 = launched).
int pls_eigen_dominant(int dtype, const void* C, void* out, int64_t B, int M, void* stream) {
  if (M < 1 || M > kMaxM || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(C, out, B, M, s));
  if (dtype == 1) return static_cast<int>(launch<double>(C, out, B, M, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* pls_eigen_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
