// Kernel SR: Shampoo's preconditioner roots, refreshed on the device.
//
// Replaces no TPU kernel.  The JAX package computes the root with XLA's
// eigh inside the jitted step (tcnn_tpu/optimizers/shampoo.py:43-50,
// under the lax.cond of :166-176), outside any pallas_call.  The port
// needs a kernel of its own so that a Shampoo step can be captured in a
// CUDA graph: torch.linalg.eigh checks cuSOLVER's status on the host, and
// the refresh cadence depends on the step counter, which a graph must read
// from device memory at each replay.  So one launch, for a list of
// preconditioners (the pointers and sizes passed by value, a table in the
// kernel's parameters that a graph node keeps), does what the lax.cond
// does:
//   1. every CTA reads the step counter t and returns at once unless
//      t == 1 or t % (t < 100 ? 10 : 200) == 0 (shampoo.h:832-838; JAX's
//      shampoo.py:140-141), so on any other step it writes nothing;
//   2. a cluster of CTAs per matrix forms S = sym(L)·(1 − s) + s·I in fp32,
//      in JAX's order of operations;
//   3. diagonalises S in fp64 by cyclic Jacobi in the parallel
//      (round-robin) order: a sweep is m − 1 rounds (m = n rounded up to
//      even; an odd n pairs one index with a dummy each round, which is
//      skipped), each round n/2 disjoint pairs rotated at once, A ← JᵀAJ
//      and V ← VJ.  A pair (p, q) is rotated only where |a_pq| >
//      ε·√|a_pp|·√|a_qq| (ε of fp32, the root's type), the relative test
//      that gives Jacobi its high relative accuracy on positive definite
//      matrices (their eigenvalues span about 10^5 here); a sweep that
//      rotates nothing ends the iteration, and so does the cap of
//      max_sweeps sweeps (the diagonal is then taken as it is, finite).
//      The rotation is Golub and Van Loan's symmetric Schur pair
//      (Algorithm 8.4.1), the rotated pair's diagonal set from its closed
//      form and a_pq to 0;
//   4. writes root = V·diag(max(w, 1e-12)^(−1/4))·Vᵀ over the old root, as
//      JAX's :48-50 does, by 64 x 64 output tiles staged in shared memory,
//      summed in fp64 and rounded once.
// fp64, because in fp32 each of the about 15n rotations that touch an
// entry adds its rounding, and the root strays further from the float64
// root of the same S than float32 eigh's.  In fp64 it lies within about an
// ulp of that root, and the tests hold it to 32 ulps.
// No atomics and a fixed order of operations: the same matrices give the
// same bits on every launch, every rank and every cluster size.  Each
// cluster writes its sweeps and the rotations it applied to stats.
//
// A round, in two phases and one cluster barrier:
//   * every CTA of the cluster computes all n/2 rotations of the round
//     itself, from the diagonal (each CTA keeps its own copy in shared
//     memory, updated by the closed form) and the pairs' a_pq (a buffer
//     of the round's pair values, written in the round before), so the
//     CTAs agree on every rotation, bit for bit, with no exchange;
//   * the cluster's warps then update A block by block: the 2 x 2 block
//     of rows (p1, q1) and columns (p2, q2) of two pairs becomes
//     J1ᵀ·X·J2, each entry the four products summed as (T11 + T22) +
//     (T12 + T21), a sum that the transposed block gives the same bits,
//     so A stays symmetric bit for bit.  A thread whose block holds a pair
//     of the next round writes its value to the other half of the buffer.
//     Vᵀ's rows p and q take the same rotation.  A warp's task is one pair
//     k1 and 128 pairs k2 (or 128 columns of Vᵀ), each lane's four items
//     loaded before any is stored; consecutive lanes take consecutive
//     pairs, which the round-robin order lays out as two runs of
//     consecutive columns, so the loads coalesce.
// A and Vᵀ live in a scratch buffer the caller allocates (L2-resident at
// these sizes), read with ld.global.cg past L1; the cluster's barrier
// (release and acquire at cluster scope) orders one round's writes before
// the next round's reads.  The cluster takes 8 CTAs, 16 where the
// launch's largest n passes 192, spread over as many SMs; a round's time
// falls as 1/CTAs (its traffic through each SM's L2 port), which the
// cluster's limit of 16 caps.
//
// Bound: an eigendecomposition with vectors is about 9n³ operations (the
// symmetric QR algorithm with its rotations accumulated, Golub and Van
// Loan §8.3) and the root's product 2n³, over the fp32 peak; the bytes are
// L read and the root written once.  The kernel does more: about 15 sweeps
// of about 9n³ each, and a chain of two barriers a round.  A refresh comes
// once every 10 or 200 steps.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "kernels.h"

namespace cg = cooperative_groups;

namespace tcnn_tpu_torch {
namespace {

constexpr int kSrThreads = 512;
constexpr int kSrWarps = kSrThreads / 32;
constexpr float kSrTol = 1.1920929e-7f;   // fp32 epsilon: the root is fp32
constexpr int kSrTile = 64;               // the root's output tile
constexpr int kSrTileK = 16;              // its steps over k
constexpr int kSrItems = 4;               // a lane's items of a task, loaded before any store
constexpr int kSrSpan = 32 * kSrItems;    // the columns (or pairs) of a task

__host__ __device__ inline int sr_half(int n) { return (n + 1) / 2; }

// Shared memory, in 8-byte words: the diagonal (m doubles), then the
// round's arrays (c and s of each of h pairs; p, q and the rotate flag;
// the next round's partner and pair of each index), which the root's two
// tiles reuse.
inline int64_t sr_smem_words(int n) {
  const int64_t h = sr_half(n), m = 2 * h;
  return m + std::max<int64_t>(2 * h + (3 * h + 2 * m + 1) / 2, 2 * kSrTileK * kSrTile);
}

// Pair k of round r of the round-robin order on m indices (the circle
// method: index m − 1 stays, the others turn); every pair once a sweep.
__device__ __forceinline__ void pair_of(int m, int r, int k, int& p, int& q) {
  int a = r, b = m - 1;
  if (k > 0) {
    a = (r + k) % (m - 1);
    b = (r - k + m - 1) % (m - 1);
  }
  p = min(a, b);
  q = max(a, b);
}

// Entry (i, j) of S = sym(L)·(1 − s) + s·I in fp32, JAX's operations.
__device__ __forceinline__ float sym_entry(const float* __restrict__ L, int n, int i, int j,
                                           float keep, float identity) {
  const float v = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(L[i * n + j], L[j * n + i])), keep);
  return i == j ? __fadd_rn(v, identity) : v;
}

// Entry (i, j) of J1ᵀ·X·J2: row i takes (u, v) of rows (p1, q1), column j
// (w, z) of columns (p2, q2).  The sum's order is symmetric in the two
// cross terms, so the transposed block gives the same bits.
__device__ __forceinline__ double block_entry(double u, double v, double w, double z,
                                              double x11, double x12, double x21, double x22) {
  return __dadd_rn(__dadd_rn(__dmul_rn(__dmul_rn(u, w), x11), __dmul_rn(__dmul_rn(v, z), x22)),
                   __dadd_rn(__dmul_rn(__dmul_rn(u, z), x12), __dmul_rn(__dmul_rn(v, w), x21)));
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = threadIdx.x < kSrWarps ? red[threadIdx.x] : 0;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kSrThreads)
    shampoo_root_kernel(const int32_t* __restrict__ step, ShampooRootBatch batch, float identity,
                        float keep, int max_sweeps, int32_t* __restrict__ stats) {
  const int t_step = *step;
  if (!(t_step == 1 || t_step % (t_step < 100 ? 10 : 200) == 0)) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int b = blockIdx.x / cl;
  const float* __restrict__ L = batch.mats[b];
  float* __restrict__ root = batch.roots[b];
  const int n = batch.n[b], h = sr_half(n), m = 2 * h;
  double* A = reinterpret_cast<double*>(batch.scratch[b]);
  double* VT = A + int64_t(n) * n;
  double* P = VT + int64_t(n) * n;   // the pairs' a_pq, two rounds' halves

  extern __shared__ __align__(16) double smem[];
  __shared__ int red[kSrWarps];
  double* d = smem;
  double* pc = d + m;
  double* ps = pc + h;
  int* pp = reinterpret_cast<int*>(ps + h);
  int* pq = pp + h;
  int* pflag = pq + h;
  int* nxq = pflag + h;   // the next round's partner of the pair's smaller index, else −1
  int* nxk = nxq + m;     // and that pair's number

  const int tid = threadIdx.x, lane = tid & 31;
  const int gtid = rank * kSrThreads + tid, gthreads = cl * kSrThreads;
  const int gwarp = rank * kSrWarps + (tid >> 5), gwarps = cl * kSrWarps;
  for (int e = gtid; e < n * n; e += gthreads) {
    const int i = e / n, j = e - i * n;
    A[e] = sym_entry(L, n, i, j, keep, identity);
    VT[e] = i == j ? 1.0 : 0.0;
  }
  for (int i = tid; i < m; i += kSrThreads)
    d[i] = i < n ? sym_entry(L, n, i, i, keep, identity) : 0.0;
  if (rank == 0)
    for (int k = tid; k < h; k += kSrThreads) {
      int p, q;
      pair_of(m, 0, k, p, q);
      P[k] = q < n ? sym_entry(L, n, p, q, keep, identity) : 0.0;
    }
  cluster.sync();

  int sweep = 0, rotations = 0, g = 0;
  // Phase 2's tasks: a pair k1 and kSrSpan pairs k2 of A's blocks, then a
  // pair and kSrSpan columns of Vᵀ's rows.
  const int a_spans = (h + kSrSpan - 1) / kSrSpan, v_spans = (n + kSrSpan - 1) / kSrSpan;
  const int a_tasks = h * a_spans, tasks = a_tasks + h * v_spans;
  for (;;) {
    ++sweep;
    int rotated = 0;
    for (int r = 0; r < m - 1; ++r, ++g) {
      const double* Pc = P + (g & 1) * h;
      double* Pn = P + ((g + 1) & 1) * h;
      const int rn = r + 1 == m - 1 ? 0 : r + 1;
      // Phase 1, in every CTA alike: the round's rotations.
      for (int k = tid; k < h; k += kSrThreads) {
        int p, q;
        pair_of(m, r, k, p, q);
        double c = 1.0, s = 0.0;
        int flag = 0;
        if (q < n) {
          const double apq = __ldcg(Pc + k), app = d[p], aqq = d[q];
          if (fabs(apq) > kSrTol * sqrt(fabs(app)) * sqrt(fabs(aqq))) {
            const double tau = (aqq - app) / (2.0 * apq);
            const double t = copysign(1.0, tau) / (fabs(tau) + sqrt(1.0 + tau * tau));
            c = 1.0 / sqrt(1.0 + t * t);
            s = t * c;
            d[p] = app - t * apq;
            d[q] = aqq + t * apq;
            flag = 1;
            ++rotations;
          }
        }
        pp[k] = p;
        pq[k] = q;
        pc[k] = c;
        ps[k] = s;
        pflag[k] = flag;
        rotated |= flag;
        int p2, q2;
        pair_of(m, rn, k, p2, q2);
        nxq[p2] = q2;
        nxk[p2] = k;
        nxq[q2] = -1;
      }
      __syncthreads();
      // Phase 2, a task a warp over the cluster's warps.
      for (int task = gwarp; task < tasks; task += gwarps) {
        if (task < a_tasks) {
          const int k1 = task / a_spans, k0 = (task - k1 * a_spans) * kSrSpan;
          const int p1 = pp[k1], q1 = pq[k1], f1 = pflag[k1];
          const bool r2 = q1 < n;
          const int np = nxq[p1], nq = r2 ? nxq[q1] : -1;
          double x[kSrItems][4];
#pragma unroll
          for (int u = 0; u < kSrItems; ++u) {
            const int k2 = k0 + lane + 32 * u;
            x[u][0] = x[u][1] = x[u][2] = x[u][3] = 0.0;
            if (k2 >= h || k2 == k1) continue;
            const int p2 = pp[k2], q2 = pq[k2];
            const bool c2 = q2 < n;
            if (!(f1 | pflag[k2]) && np != p2 && !(c2 && np == q2) && nq != p2 &&
                !(c2 && nq == q2))
              continue;
            x[u][0] = __ldcg(A + p1 * n + p2);
            if (c2) x[u][1] = __ldcg(A + p1 * n + q2);
            if (r2) x[u][2] = __ldcg(A + q1 * n + p2);
            if (r2 && c2) x[u][3] = __ldcg(A + q1 * n + q2);
          }
#pragma unroll
          for (int u = 0; u < kSrItems; ++u) {
            const int k2 = k0 + lane + 32 * u;
            if (k2 >= h) continue;
            if (k2 == k1) {
              if (f1) {
                A[p1 * n + q1] = 0.0;
                A[q1 * n + p1] = 0.0;
              }
              if (r2 && np == q1)   // m == 2: the same pair again
                Pn[nxk[p1]] = f1 ? 0.0 : __ldcg(A + p1 * n + q1);
              continue;
            }
            const int p2 = pp[k2], q2 = pq[k2];
            const bool c2 = q2 < n;
            double y11 = x[u][0], y12 = x[u][1], y21 = x[u][2], y22 = x[u][3];
            if (f1 | pflag[k2]) {
              const double c1 = pc[k1], s1 = ps[k1], cc = pc[k2], ss = ps[k2];
              y11 = block_entry(c1, -s1, cc, -ss, x[u][0], x[u][1], x[u][2], x[u][3]);
              y12 = block_entry(c1, -s1, ss, cc, x[u][0], x[u][1], x[u][2], x[u][3]);
              y21 = block_entry(s1, c1, cc, -ss, x[u][0], x[u][1], x[u][2], x[u][3]);
              y22 = block_entry(s1, c1, ss, cc, x[u][0], x[u][1], x[u][2], x[u][3]);
              A[p1 * n + p2] = y11;
              if (c2) A[p1 * n + q2] = y12;
              if (r2) A[q1 * n + p2] = y21;
              if (r2 && c2) A[q1 * n + q2] = y22;
            }
            // The next round's pair values this block holds (a row's
            // partner, where the row is the pair's smaller index).
            if (np == p2) Pn[nxk[p1]] = y11;
            else if (c2 && np == q2) Pn[nxk[p1]] = y12;
            if (nq == p2) Pn[nxk[q1]] = y21;
            else if (c2 && nq == q2) Pn[nxk[q1]] = y22;
          }
        } else {
          const int k = (task - a_tasks) / v_spans;
          if (!pflag[k]) continue;
          const int j0 = (task - a_tasks - k * v_spans) * kSrSpan;
          double* vp = VT + pp[k] * n;
          double* vq = VT + pq[k] * n;
          const double c = pc[k], s = ps[k];
          double x[kSrItems][2];
#pragma unroll
          for (int u = 0; u < kSrItems; ++u) {
            const int j = j0 + lane + 32 * u;
            if (j < n) {
              x[u][0] = __ldcg(vp + j);
              x[u][1] = __ldcg(vq + j);
            }
          }
#pragma unroll
          for (int u = 0; u < kSrItems; ++u) {
            const int j = j0 + lane + 32 * u;
            if (j < n) {
              vp[j] = c * x[u][0] - s * x[u][1];
              vq[j] = s * x[u][0] + c * x[u][1];
            }
          }
        }
      }
      cluster.sync();
    }
    if (!__syncthreads_or(rotated) || sweep >= max_sweeps) break;
  }

  for (int k = tid; k < n; k += kSrThreads) d[k] = pow(fmax(d[k], 1e-12), -0.25);
  // root_ij = Σ_k (v_ik·d_k)·v_jk, JAX's (v * w^-0.25) @ v.T, k in order,
  // in fp64, rounded once.
  double* wi = d + m;                      // (kSrTileK, kSrTile): Vᵀ's rows · d, columns i
  double* vj = wi + kSrTileK * kSrTile;    // (kSrTileK, kSrTile): Vᵀ's rows, columns j
  const int ty = tid / 16, tx = tid % 16, tiles = (n + kSrTile - 1) / kSrTile;
  for (int tile = rank; tile < tiles * tiles; tile += cl) {
    const int i0 = (tile / tiles) * kSrTile, j0 = (tile % tiles) * kSrTile;
    double acc[2][4] = {};
    for (int k0 = 0; k0 < n; k0 += kSrTileK) {
      __syncthreads();
      for (int e = tid; e < kSrTileK * kSrTile; e += kSrThreads) {
        const int kk = e / kSrTile, xx = e - kk * kSrTile, k = k0 + kk;
        wi[e] = k < n && i0 + xx < n ? __ldcg(VT + k * n + i0 + xx) * d[k] : 0.0;
        vj[e] = k < n && j0 + xx < n ? __ldcg(VT + k * n + j0 + xx) : 0.0;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSrTileK; ++kk)
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][c] = fma(wi[kk * kSrTile + ty + 32 * a], vj[kk * kSrTile + tx + 16 * c],
                            acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + ty + 32 * a, j = j0 + tx + 16 * c;
        if (i < n && j < n) root[i * n + j] = float(acc[a][c]);
      }
  }
  if (rank == 0) {
    const int total = block_sum(rotations, red);
    if (tid == 0) {
      stats[2 * b] = sweep;
      stats[2 * b + 1] = total;
    }
  }
}

}  // namespace

int64_t shampoo_root_scratch_floats(int n) {
  // A and Vᵀ (n x n doubles each) and the two halves of the pair buffer,
  // rounded up to 16 bytes.
  const int64_t f = 2 * (2 * int64_t(n) * n + 2 * sr_half(n));
  return (f + 3) / 4 * 4;
}

cudaError_t shampoo_root_launch(const int32_t* step, const float* const* mats,
                                float* const* roots, const int* sizes, int count, double identity,
                                float* scratch, int32_t* stats, int max_sweeps,
                                cudaStream_t stream) {
  if (count < 1 || count > kShampooRootMaxMatrices || max_sweeps < 1 ||
      max_sweeps > kShampooRootMaxSweeps)
    return cudaErrorInvalidValue;
  ShampooRootBatch batch{};
  int n_max = 0;
  int64_t offset = 0;
  for (int i = 0; i < count; ++i) {
    const int n = sizes[i];
    if (n < 1 || n > kShampooRootMaxN) return cudaErrorInvalidValue;
    batch.mats[i] = mats[i];
    batch.roots[i] = roots[i];
    batch.n[i] = n;
    batch.scratch[i] = scratch + offset;
    offset += shampoo_root_scratch_floats(n);
    n_max = std::max(n_max, n);
  }
  // The CTAs of a matrix's cluster, by the launch's largest n.
  const int cl = n_max <= 192 ? 8 : 16;
  const int smem = int(sr_smem_words(n_max) * 8);
  cudaError_t err = cudaFuncSetAttribute(shampoo_root_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cl > 8)
    err = cudaFuncSetAttribute(shampoo_root_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config{};
  config.gridDim = dim3(unsigned(count * cl));
  config.blockDim = dim3(kSrThreads);
  config.dynamicSmemBytes = size_t(smem);
  config.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = unsigned(cl);
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attrs[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;
  config.attrs = attrs;
  config.numAttrs = 2;
  err = cudaLaunchKernelEx(&config, shampoo_root_kernel, step, batch, float(identity),
                           float(1.0 - identity), max_sweeps, stats);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace tcnn_tpu_torch
