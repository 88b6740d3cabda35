// The broadcast predictor's RNN (paper Sec. 5) in one launch: S predictor
// steps of one cluster, in order, with the weights carried on chip from step
// to step. Each step p:
//   learn   (gate bit 1): one SGD step on -log_softmax(logits(pre[p]))[label],
//           label = lab[p, fire]: the forward of the 2-layer, 128-wide tanh
//           RNN over the (T, 1) window, backpropagation through time over
//           both layers by hand, and p <- p - lr g on all 8 leaves;
//   decide  (gate bit 2): want = argmax(logits(post[p])) == 1, the first
//           index on a tie and a NaN counting as the maximum (jnp.argmax,
//           torch.argmax);
//   fallback (gate bit 4, wins over decide): want = fb[p, fire];
//   then fire <- p + 1 where want. `fire` lives in a register: no host sync.
//
// Replaces no pallas_call. It replaces the reference's jitted bodies of the
// predictor's device work: src/repro/kernels/ops.py:541 _predictor_chain_jit
// (a lax.scan of src/repro/core/broadcast.py:129 rnn_chain_step),
// broadcast.py:71 _rnn_sgd, :81 _rnn_want, and the per-window _rnn_sgd loop
// of pretrain_rnn (:258). The port's entry points all launch this kernel
// (kernels/rnn.py): a per-event upload's learn and decision are S = 1 with
// the one or both gates, a coalesced window's chain S steps, and the
// pretraining S = 1,200 learn steps at lr 5e-3 with one label column. They
// run the same device code for a step, whatever S, so a chain is bit for bit
// the same steps as per-event launches, and a learn and decision in one step
// the same as a learn launch then a decision launch.
//
// Weights: wx0 (1, 128), wh0 (128, 128), b0 (128), wx1 (128, 128), wh1
// (128, 128), b1 (128), w_out (128, 2), b_out (2): 49,794 floats, the leaves
// of init_rnn in that order. The kernel never writes its inputs: a launch
// with a learn step writes the final weights to a fresh flat buffer `out`, as
// the reference's functional update does (an expanded cluster's predictor
// shares its parent's weight tensors).
//
// Bound. One SGD step at T = 10 is about 3 MFLOP (9 T matrix-vector products
// and outer-product sums of 128 x 128) and 0.4 MB of weights in and out; each
// step waits on the one before, and each time step of the recurrence on the
// last, so the work is one chain of ~2 T dependent passes and an update. One
// block is held to one SM's fp32 rate: 128 FMA lanes, so a pass of 3
// matrix-vector products (49,152 FMAs) takes at least 384 clocks, a learn at
// T = 10 ~12,000 (~6 us), the 1,200-state pretraining ~7 ms. What limits a
// pass now (PERF.md section 6): instructions, not shared memory. A thread's 96
// FMAs a pass come with the loads of h, the reduce-scatter's shuffles and
// adds, the cross-tile sums and two tanhf (each row tile's four warps
// compute the same 32 entries of h), with the 16 warps in lockstep between
// barriers, so the chain of latencies is not hidden, and no one of these
// costs dominates. A launch adds a fixed cost of its own (the operand copy,
// the weights in and out, the first pass through the code).
//
// Design: a block of 512 threads, one or a cluster of two. No pass reads a
// weight matrix from shared memory (three would be 196,608 B a pass), and a
// pass takes one barrier.
//   - wh0, wx1 and wh1 live in registers for the whole launch. Block r of kCl
//     holds columns r 128 / kCl .. of every row; in it thread (warp w, lane l)
//     holds the block of rows i0 .. i0 + 7 and kColsT = 4 / kCl columns from
//     j0 of each matrix, i0 = 32 (w / 4) + 8 (l % 4), j0 = r 128 / kCl +
//     kTileC (w % 4) + kColsT (l / 4): 96 floats (48 in a cluster), loaded
//     once, updated in registers and written once at the end. A warp owns a
//     32 x kTileC tile (kTileC = 32 / kCl) of each matrix. The small leaves
//     (wx0, b0, b1, w_out, b_out) stay in shared memory, in each block.
//   - The forward h @ W: each thread sums its 8 rows for its columns (fmaf,
//     rows ascending), reading h as 16-byte loads of its 8 rows (four
//     addresses a warp, on distinct banks); a reduce-scatter of shuffles over
//     the warp's 4 row groups leaves each lane one column's warp sum,
//     (S0 + S2) + (S1 + S3); the 4 row tiles' sums go through shared memory
//     (in a cluster, both blocks') and are added ((r0 + r1) + r2) + r3.
//   - The backward W @ dz: each thread sums its columns for its 8 rows (fmaf,
//     columns ascending); a reduce-scatter over the warp's 8 column groups (7
//     shuffles) leaves each lane one row's warp sum,
//     ((C0 + C4) + (C2 + C6)) + ((C1 + C5) + (C3 + C7)); the column tiles'
//     sums (4, or 8 over a cluster) go to the shared memory of the block
//     whose columns the row's entry is, and are added in order.
//   - One barrier a pass (the cluster's, over two blocks). The cross-tile
//     sums are double-buffered: a pass writes its partials to one buffer,
//     passes alternate buffers, and the next pass begins by reading them,
//     each warp for the 32 entries of h (or kTileC of dz) it needs (lane l
//     the entry 32 (w / 4) + l forward; the four warps of a row tile compute
//     them alike: two tanhf a lane a pass), into a 64-float buffer of its
//     own, then __syncwarp. The output layer's logits are computed by every
//     warp from the last pass's partials, so the loss, dlogits and the
//     decision need no barrier. A learn at T = 10 takes 22 barriers.
//   - The two layers run as a wavefront: forward pass p computes layer 0's
//     step p and layer 1's step p - 1 (both read h0_{p-1}): T passes (step 0's
//     h0 needs no product). The backward pass t computes wh1 @ dz1_t,
//     wx1 @ dz1_t and wh0 @ dz0_{t+1}, which give dz1_{t-1} and dz0_t: T
//     passes.
//   - No gradient buffer: each layer's inputs (h0_t, h1_t) and deltas (dz0_t,
//     dz1_t) are kept for the T steps (each block its own copy; a cluster's
//     blocks store each delta in both), and after the backward each thread
//     applies W[i][j] <- W[i][j] - lr * sum_t a_t[i] dz_t[j] to the weights
//     it holds, two rows at a time, each sum over t in descending order
//     (autograd's visiting order). The histories take 4 T 128 floats a
//     block: in shared memory up to T = 104 (one block), else in a global
//     scratch the wrapper allocates (the cluster's).
//   - Which variant: the window length alone decides. One block while the
//     histories fit on its chip (T <= 104), a cluster of two past that, where
//     the one block's global history addresses would spill its registers.
//     Timed at T = 10 the cluster was the slower (its barrier crosses SMs;
//     PERF.md), so it runs only past 104, with its histories in the scratch.
//     The scratch's four histories sit kMaxT rows apart whatever T is: a
//     constant stride keeps their places out of registers (a stride of T
//     would hold them in four, which this kernel has not to spare).
//   - Every update is __fmul_rn then __fsub_rn (no FMA contraction in
//     updates and blends, the repo's rule); tanh_backward is
//     g * (1 - y * y), each op rounded once, as autograd takes it.
//   - Each thread owns fixed elements and every sum has the fixed order
//     above, so a launch gives the same bits every time. tanhf, expf and logf
//     are the CUDA library's, not numpy's or the CPU's: the kernel is held to
//     its plain version by tolerance, and by the bitwise rules between its
//     own entry points (PERF.md). tests/torch_rnn_model.py models the sums'
//     order (kernel_grads).
//   - No tensor cores: a batch-1 recurrence is a chain of matrix-vector
//     products (M = 1), which fills one row of a 64-row wgmma tile, and a
//     TF32 or split-TF32 product would change the numbers the card's
//     tolerances hold the kernel to (one step within rtol 1e-6 of the fp32
//     plain step).
//   - T up to kMaxT = 1,024 (the largest fleet a path runs has 128 clients,
//     so k = max(top_k, cluster size) <= 128); the wrapper raises above it.
//   - The host side: one C call a launch (a 25-field descriptor); the
//     operands are staged through a ring of 4 reused pinned slots and copied
//     on the launch's stream, a slot rewritten only once its copy has run.
#include <cooperative_groups.h>

#include <cstring>
#include <mutex>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kH = 128;                      // hidden width (core/broadcast.py HIDDEN)
constexpr int kThreadsRnn = 512;
constexpr int kWarps = kThreadsRnn / 32;
constexpr int kRowsT = 8;                    // a thread's rows of each matrix
constexpr int kRowGroups = 4;                // lanes l % 4: a warp's row groups
constexpr int kColGroups = 8;                // lanes l / 4: a warp's column groups
constexpr int kTile = kRowsT * kRowGroups;   // a warp's rows: 32
constexpr int kTiles = kH / kTile;           // row tiles (w / 4) and a block's column tiles (w % 4): 4
static_assert(kRowGroups * kColGroups == 32 && kTiles * kTiles == kWarps, "16 warps in 4 x 4 tiles");
constexpr int kMaxT = 1024;
constexpr int kLearn = 1, kDecide = 2, kFallback = 4;

// the leaves in the flat weight buffer, init_rnn's order
constexpr int kOffWx0 = 0, kOffWh0 = kOffWx0 + kH, kOffB0 = kOffWh0 + kH * kH, kOffWx1 = kOffB0 + kH,
              kOffWh1 = kOffWx1 + kH * kH, kOffB1 = kOffWh1 + kH * kH, kOffWout = kOffB1 + kH,
              kOffBout = kOffWout + 2 * kH, kLeafFloats = kOffBout + 2;
static_assert(kLeafFloats == 49794, "the RNN's 8 leaves");
constexpr int kSmemMax = 232448;             // the 227 KB a block can use

// The split of wh0, wx1 and wh1 over a cluster of kCl blocks (1 or 2): block
// r holds columns r kCols .. of every row; in it, warp w the tile of rows
// 32 (w / 4) .. and columns kTileC (w % 4) .., lane l the kRowsT x kColsT
// block at row group l % 4 and column group l / 4.
template <int kCl>
struct Split {
  static constexpr int kColsT = 4 / kCl;           // a thread's columns of each matrix
  static constexpr int kTileC = kColsT * kColGroups;  // a warp's columns: 32 or 16
  static constexpr int kCols = kH / kCl;           // a block's columns
  static constexpr int kTilesB = kTiles * kCl;      // the backward's column tiles over the cluster
  // shared memory, in floats
  static constexpr int kSWx0 = 0, kSB0 = kH, kSB1 = 2 * kH, kSWout = 3 * kH;  // w_out as [i][2]
  static constexpr int kSBout = kSWout + 2 * kH;    // 2, padded to 4
  static constexpr int kSMisc = kSBout + 4;         // a learn's dlogits (2) and loss, the fired position
  static constexpr int kPartK = kTilesB * kH;       // one product's partials: [tile][entry]
  static constexpr int kPartBuf = 3 * kPartK;       // a pass's three products
  static constexpr int kSPart = kSMisc + 4;         // two buffers, alternating pass to pass
  static constexpr int kSXw = kSPart + 2 * kPartBuf;  // each warp's 2 x 32 entries of h (or dz)
  static constexpr int kSHist = kSXw + kWarps * 2 * kTile;  // one block's H0, H1, D0, D1, kSharedT rows each
  static constexpr int kSharedT = (kSmemMax / 4 - kSHist) / (4 * kH);
  static constexpr bool kShared = kCl == 1;         // the histories in shared memory, else in the scratch
  static_assert(kColsT * kCl == 4 && kTileC * kTiles == kCols, "the block's columns in 4 column tiles");
  static_assert(kSHist % 4 == 0 && kSPart % 4 == 0 && kSXw % 4 == 0, "16-byte aligned vectors");
  static constexpr size_t smem_bytes = sizeof(float) * (kSHist + (kShared ? 4 * kSharedT * kH : 0));
};
static_assert(Split<1>::kSharedT == 104, "one block's histories on chip to windows of 104");
static_assert(Split<1>::smem_bytes <= kSmemMax && Split<2>::smem_bytes <= kSmemMax,
              "fits the 227 KB a block can use");

struct RnnArgs {
  const float* w[8];   // wx0, wh0, b0, wx1, wh1, b1, w_out, b_out
  const float* pre;    // (S, T) learn windows
  const float* post;   // (S, T) decision windows; read only at decide steps
  const int* lab;      // (S, cols) labels, 0 or 1
  const int* fb;       // (S, cols) fallback decisions; read only at fallback steps
  const int* gates;    // (S,) kLearn | kDecide | kFallback
  float* out;          // the final weights (kLeafFloats), or null: no step learns
  float* loss;         // (S,) each learn step's loss (0 elsewhere)
  unsigned char* want; // (S,)
  float* scratch;      // 4 kMaxT 128 floats a block in a cluster
  int S, T, cols;
  float lr;
};

// A thread's place: its block's rank in the cluster, its warp's tile (wr,
// wc), its row group rg and column group cg in the tile, the first row i0
// and column j0 of its blocks, and the entries it computes for its warp at
// the top of a pass: n forward (the warp's rows), c backward (the warp's
// columns). Only lane, warp and rank are kept; the rest are recomputed where
// used, which leaves the registers to the weights.
template <int kCl>
struct Place {
  using L = Split<kCl>;
  int lane, warp, rank;
  __device__ Place(int tid, int r) : lane(tid & 31), warp(tid >> 5), rank(r) {}
  __device__ int wr() const { return warp / kTiles; }
  __device__ int wc() const { return warp % kTiles; }
  __device__ int rg() const { return lane % kRowGroups; }
  __device__ int cg() const { return lane / kRowGroups; }
  __device__ int i0() const { return kTile * wr() + kRowsT * rg(); }
  __device__ int j0() const { return rank * L::kCols + L::kTileC * wc() + L::kColsT * cg(); }
  __device__ int n() const { return kTile * wr() + lane; }
  __device__ int c() const { return rank * L::kCols + L::kTileC * wc() + lane % L::kTileC; }
};

// One pass's barrier: the block's, or the cluster's when the pass's partials
// cross blocks (its arrive releases and its wait acquires the stores to the
// other block's shared memory).
template <int kCl>
__device__ __forceinline__ void pass_barrier() {
  if constexpr (kCl == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// A store to this block's shared memory and, in a cluster, the same place in
// the other block's (`remote` - `s` apart).
template <int kCl>
__device__ __forceinline__ void store_all(float* p, float v, float* s, float* remote) {
  *p = v;
  if constexpr (kCl == 2) remote[p - s] = v;
}

// A store to this block's history D at i and, in a cluster, to the other
// block's copy rD (in its shared memory, or its part of the scratch).
template <int kCl>
__device__ __forceinline__ void store_hist(float* D, float* rD, int i, float v) {
  D[i] = v;
  if constexpr (kCl == 2) rD[i] = v;
}

// The store of an entry only its owner block reads (a backward partial).
template <int kCl>
__device__ __forceinline__ void store_at(float* p, float v, bool mine, float* s, float* remote) {
  if (kCl == 1 || mine) {
    *p = v;
  } else {
    remote[p - s] = v;
  }
}

template <int kC>
struct Weights {  // wh0, wx1 and wh1 at rows i0 + a, columns j0 + b: in registers for the launch
  float wh0[kRowsT][kC], wx1[kRowsT][kC], wh1[kRowsT][kC];
};

template <int kC>
__device__ __forceinline__ void load_block(float (&w)[kRowsT][kC], const float* src, int i0, int j0) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll
  for (int a = 0; a < kRowsT; ++a) {
    const float* row = src + (i0 + a) * kH + j0;
    if (kC == 4 && vec) {
      const float4 v = *reinterpret_cast<const float4*>(row);
      w[a][0] = v.x, w[a][1] = v.y, w[a][kC - 2] = v.z, w[a][kC - 1] = v.w;
    } else {
#pragma unroll
      for (int b = 0; b < kC; ++b) w[a][b] = row[b];
    }
  }
}

template <int kC>
__device__ __forceinline__ void store_block(const float (&w)[kRowsT][kC], float* dst, int i0, int j0) {
#pragma unroll
  for (int a = 0; a < kRowsT; ++a) {  // out is a fresh buffer: rows 16-byte aligned, a warp's row 128 B or 64 B
    float* row = dst + (i0 + a) * kH + j0;
    if constexpr (kC == 4) {
      *reinterpret_cast<float4*>(row) = make_float4(w[a][0], w[a][1], w[a][kC - 2], w[a][kC - 1]);
    } else {
      *reinterpret_cast<float2*>(row) = make_float2(w[a][0], w[a][kC - 1]);
    }
  }
}

// ((part[0][n] + part[1][n]) + part[2][n]) + ...: the tiles' sums in order
template <int kN>
__device__ __forceinline__ float sum_tiles(const float* part, int n) {
  float v = part[n];
#pragma unroll
  for (int k = 1; k < kN; ++k) v = __fadd_rn(v, part[k * kH + n]);
  return v;
}

// keep + the partner's send, the partner across lane bit `mask`
__device__ __forceinline__ float pair(bool hi, float lo_keep, float hi_keep, int mask) {
  const float send = hi ? lo_keep : hi_keep;
  return __fadd_rn(hi ? hi_keep : lo_keep, __shfl_xor_sync(0xffffffffu, send, mask));
}

// The forward's reduce-scatter over the warp's 4 row groups (lane bits 0-1):
// v holds this thread's sums for columns j0 .. j0 + kC - 1; returns column
// j0 + rg's (kC = 4) or j0 + rg / 2's (kC = 2, in lanes rg and rg ^ 1) sum
// over the tile's 32 rows, (S0 + S2) + (S1 + S3).
__device__ __forceinline__ float scatter_cols(const float (&v)[4], int lane) {
  const bool b1 = lane & 2, b0 = lane & 1;
  const float w0 = pair(b1, v[0], v[2], 2), w1 = pair(b1, v[1], v[3], 2);  // columns 2 b1, 2 b1 + 1
  return pair(b0, w0, w1, 1);                                               // column 2 b1 + b0 = rg
}
__device__ __forceinline__ float scatter_cols(const float (&v)[2], int lane) {
  const float w = pair(lane & 2, v[0], v[1], 2);                // column b1
  return __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, 1));      // and its other half
}

// The backward's reduce-scatter over the warp's 8 column groups (lane bits
// 2-4): v holds this thread's sums for rows i0 .. i0 + 7; returns row
// i0 + cg's sum over the tile's columns,
// ((C0 + C4) + (C2 + C6)) + ((C1 + C5) + (C3 + C7)).
__device__ __forceinline__ float scatter_rows(const float (&v)[kRowsT], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w[4], y[2];
#pragma unroll
  for (int m = 0; m < 4; ++m) w[m] = pair(b4, v[m], v[m + 4], 16);  // rows 4 b4 + m
#pragma unroll
  for (int m = 0; m < 2; ++m) y[m] = pair(b3, w[m], w[m + 2], 8);   // rows 4 b4 + 2 b3 + m
  return pair(b2, y[0], y[1], 4);                                    // row 4 b4 + 2 b3 + b2 = cg
}

// g * (1 - y * y): the gradient through y = tanh(z), each op rounded once
__device__ __forceinline__ float tanh_back(float g, float y) {
  return __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(y, y)));
}

// p - lr * g
__device__ __forceinline__ float sgd(float p, float lr, float g) { return __fsub_rn(p, __fmul_rn(lr, g)); }

// threadIdx.x read afresh: an index used once, far from the others, holds no register in between
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// h @ W for the thread's block: acc[b] += sum_a h[i0 + a] W[a][b], rows
// ascending, h read as 16-byte loads of the warp's h (xw) at rows 8 rg ..
template <int kC>
__device__ __forceinline__ void rows_product(const float* xw, int rg, const float (&W)[kRowsT][kC], float (&acc)[kC]) {
#pragma unroll
  for (int b = 0; b < kC; ++b) acc[b] = 0.f;
#pragma unroll
  for (int v = 0; v < kRowsT / 4; ++v) {
    const float4 u4 = *reinterpret_cast<const float4*>(xw + kRowsT * rg + 4 * v);
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int b = 0; b < kC; ++b) acc[b] = fmaf(u[e], W[4 * v + e][b], acc[b]);
    }
  }
}

// W @ dz for the thread's block: r[a] = sum_b W[a][b] d[b], columns ascending
template <int kC>
__device__ __forceinline__ void cols_product(const float (&W)[kRowsT][kC], const float (&d)[kC], float (&r)[kRowsT]) {
#pragma unroll
  for (int a = 0; a < kRowsT; ++a) {
    r[a] = 0.f;
#pragma unroll
    for (int b = 0; b < kC; ++b) r[a] = fmaf(W[a][b], d[b], r[a]);
  }
}

// h1 at entry i from the last forward pass's partials P
template <int kCl>
__device__ __forceinline__ float h1_at(const float* s, const float* P, int i) {
  using L = Split<kCl>;
  return tanhf(__fadd_rn(__fadd_rn(sum_tiles<kTiles>(P + L::kPartK, i), sum_tiles<kTiles>(P + 2 * L::kPartK, i)),
                         s[L::kSB1 + i]));
}

// The forward over the window x (T,): H0[t] = h0_t, H1[t] = h1_t, and in
// every thread the logits (l0, l1) and h1_{T-1} at its backward entry c (hl).
// `ph` is the partial buffer of the last pass, each pass the other one.
template <int kCl>
__device__ __forceinline__ void forward(float* s, float* remote, const float* x, int T, float* H0, float* H1,
                                        const Weights<Split<kCl>::kColsT>& w, const Place<kCl>& pl, int& ph,
                                        float& l0, float& l1, float& hl) {
  using L = Split<kCl>;
  constexpr int kC = L::kColsT;
  float* xw = s + L::kSXw + pl.warp * 2 * kTile;  // this warp's h0 (32), h1 (32) at rows 32 wr ..
  const int n = pl.n();
  // the entry this lane's partials hold after the reduce-scatter; with two columns a thread, lanes rg and rg ^ 1
  // hold the same column and the even one stores it
  const int col = pl.j0() + (kC == 4 ? pl.rg() : pl.rg() >> 1);
  const bool stores = kC == 4 || !(pl.lane & 1);
  for (int p = 1; p <= T; ++p) {
    const float* P = s + L::kSPart + ph * L::kPartBuf;  // pass p - 1's partials (none at p = 1)
    // h0_{p-1} = tanh(x_{p-1} wx0 + h0_{p-2} @ wh0 + b0); at p = 1 the product of the zero state is +0
    const float hh = p >= 2 ? sum_tiles<kTiles>(P, n) : 0.f;
    const float h0 = tanhf(__fadd_rn(__fadd_rn(__fmul_rn(x[p - 1], s[L::kSWx0 + n]), hh), s[L::kSB0 + n]));
    const float h1 = p >= 2 ? h1_at<kCl>(s, P, n) : 0.f;  // h1_{p-2}
    if (pl.wc() == 0) {
      H0[(p - 1) * kH + n] = h0;
      if (p >= 2) H1[(p - 2) * kH + n] = h1;
    }
    xw[pl.lane] = h0;
    xw[kTile + pl.lane] = h1;
    __syncwarp();
    ph ^= 1;
    float* Q = s + L::kSPart + ph * L::kPartBuf + pl.wr() * kH + col;
    float acc[kC];
    rows_product(xw, pl.rg(), w.wh0, acc);  // h0_{p-1} @ wh0: layer 0's step p (unused at p = T)
    float v = scatter_cols(acc, pl.lane);
    if (stores && p < T) store_all<kCl>(Q, v, s, remote);
    rows_product(xw, pl.rg(), w.wx1, acc);  // h0_{p-1} @ wx1: layer 1's step p - 1
    v = scatter_cols(acc, pl.lane);
    if (stores) store_all<kCl>(Q + L::kPartK, v, s, remote);
    rows_product(xw + kTile, pl.rg(), w.wh1, acc);  // h1_{p-2} @ wh1: layer 1's step p - 1
    v = scatter_cols(acc, pl.lane);
    if (stores) store_all<kCl>(Q + 2 * L::kPartK, v, s, remote);
    pass_barrier<kCl>();
  }
  // h1_{T-1} at i = lane + 32 m and logits = h1_{T-1} @ w_out + b_out, in
  // every warp: lane l sums rows l, l + 32, l + 64, l + 96 in that order,
  // then a butterfly of shuffles
  const float* P = s + L::kSPart + ph * L::kPartBuf;
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
    const int i = pl.lane + kTile * m;
    const float h = h1_at<kCl>(s, P, i);
    if (pl.warp == 0) H1[(T - 1) * kH + i] = h;
    acc0 = fmaf(h, s[L::kSWout + 2 * i], acc0);
    acc1 = fmaf(h, s[L::kSWout + 2 * i + 1], acc1);
  }
  l0 = __fadd_rn(repro::warp_sum(acc0), s[L::kSBout]);
  l1 = __fadd_rn(repro::warp_sum(acc1), s[L::kSBout + 1]);
  hl = h1_at<kCl>(s, P, pl.c());
}

// W[i][j] <- W[i][j] - lr * sum_{t = T-1 .. t_lo} A[t - lag][i] * D[t][j] for
// the thread's block, two rows at a time.
template <int kC>
__device__ __forceinline__ void update_block(float (&W)[kRowsT][kC], const float* A, int lag, const float* D,
                                             int t_lo, int T, float lr, int i0, int j0) {
#pragma unroll
  for (int r = 0; r < kRowsT; r += 2) {
    float acc[2][kC] = {};
    for (int t = T - 1; t >= t_lo; --t) {
      const float2 a = *reinterpret_cast<const float2*>(A + (t - lag) * kH + i0 + r);
      float d[kC];
      if constexpr (kC == 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(D + t * kH + j0);
        d[0] = d4.x, d[1] = d4.y, d[kC - 2] = d4.z, d[kC - 1] = d4.w;
      } else {
        const float2 d2 = *reinterpret_cast<const float2*>(D + t * kH + j0);
        d[0] = d2.x, d[kC - 1] = d2.y;
      }
#pragma unroll
      for (int b = 0; b < kC; ++b) {
        acc[0][b] = fmaf(a.x, d[b], acc[0][b]);
        acc[1][b] = fmaf(a.y, d[b], acc[1][b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kC; ++b) {
      W[r][b] = sgd(W[r][b], lr, acc[0][b]);
      W[r + 1][b] = sgd(W[r + 1][b], lr, acc[1][b]);
    }
  }
}

// One SGD step on -log_softmax(logits(x))[label]; returns the loss.
template <int kCl>
__device__ __forceinline__ float sgd_step(float* s, float* remote, const float* x, int T, int label, float lr,
                                          float* H0, float* H1, float* D0, float* D1, float* rD0, float* rD1,
                                          Weights<Split<kCl>::kColsT>& w, const Place<kCl>& pl, int& ph) {
  using L = Split<kCl>;
  constexpr int kC = L::kColsT;
  int tid = threadIdx.x;
  float l0, l1, hl;
  forward<kCl>(s, remote, x, T, H0, H1, w, pl, ph, l0, l1, hl);
  // log_softmax as the CPU takes it: (l - max) - log(sum exp(l - max)); d = softmax - onehot
  const float m = fmaxf(l0, l1);
  const float lse = logf(__fadd_rn(expf(__fsub_rn(l0, m)), expf(__fsub_rn(l1, m))));
  const float lp0 = __fsub_rn(__fsub_rn(l0, m), lse), lp1 = __fsub_rn(__fsub_rn(l1, m), lse);
  const float dl0 = __fsub_rn(expf(lp0), label == 0 ? 1.f : 0.f);
  const float dl1 = __fsub_rn(expf(lp1), label == 1 ? 1.f : 0.f);
  if (tid == 0) {  // for the update and the caller, past the backward's barriers (no registers held through it)
    s[L::kSMisc] = dl0;
    s[L::kSMisc + 1] = dl1;
    s[L::kSMisc + 2] = -(label == 1 ? lp1 : lp0);
  }
  float* xw = s + L::kSXw + pl.warp * 2 * kTile;  // this warp's dz1, dz0 at its kTileC columns
  const int c = pl.c();
  // lanes past the warp's columns (two a column with a cluster of 2) compute the same entry and do not store it
  const bool first = pl.lane < L::kTileC;
  const bool keeps = first && pl.wr() == 0;  // the lanes that write the D histories, in every block
  {  // dz1_{T-1} = (w_out @ dlogits) through tanh; dz0_T = 0
    const float g = __fadd_rn(__fmul_rn(s[L::kSWout + 2 * c], dl0), __fmul_rn(s[L::kSWout + 2 * c + 1], dl1));
    const float d = tanh_back(g, hl);
    if (keeps) store_hist<kCl>(D1, rD1, (T - 1) * kH + c, d);
    if (first) {
      xw[pl.lane] = d;
      xw[kTile + pl.lane] = 0.f;
    }
    __syncwarp();
  }
  const int row = pl.i0() + pl.cg();  // the row whose warp sum this lane holds after a reduce-scatter
  const bool mine = row / L::kCols == pl.rank;  // its dz entry is this block's
  const int tile = pl.rank * kTiles + pl.wc();    // this warp's column tile in the cluster
  for (int t = T - 1; t >= 0; --t) {
    if (t < T - 1) {  // dz1_t and dz0_{t+1} from pass t + 1's partials (its wh0 product is +0 at t + 1 = T - 1)
      const float* P = s + L::kSPart + ph * L::kPartBuf;
      const float d1 = tanh_back(sum_tiles<L::kTilesB>(P, c), H1[t * kH + c]);
      const float r0 = t + 1 < T - 1 ? sum_tiles<L::kTilesB>(P + 2 * L::kPartK, c) : 0.f;
      const float d0 = tanh_back(__fadd_rn(sum_tiles<L::kTilesB>(P + L::kPartK, c), r0), H0[(t + 1) * kH + c]);
      if (keeps) {
        store_hist<kCl>(D1, rD1, t * kH + c, d1);
        store_hist<kCl>(D0, rD0, (t + 1) * kH + c, d0);
      }
      if (first) {
        xw[pl.lane] = d1;
        xw[kTile + pl.lane] = d0;
      }
      __syncwarp();
    }
    ph ^= 1;
    float* Q = s + L::kSPart + ph * L::kPartBuf + tile * kH + row;
    float d1[kC], d0[kC], r[kRowsT];
#pragma unroll
    for (int b = 0; b < kC; ++b) {
      d1[b] = xw[kC * pl.cg() + b];          // dz1_t at j0 ..
      d0[b] = xw[kTile + kC * pl.cg() + b];  // dz0_{t+1} at j0 ..
    }
    if (t >= 1) {  // (wh1 @ dz1_t): into h1_{t-1}
      cols_product(w.wh1, d1, r);
      store_at<kCl>(Q, scatter_rows(r, pl.lane), mine, s, remote);
    }
    cols_product(w.wx1, d1, r);  // (wx1 @ dz1_t): into h0_t from layer 1
    store_at<kCl>(Q + L::kPartK, scatter_rows(r, pl.lane), mine, s, remote);
    if (t < T - 1) {  // (wh0 @ dz0_{t+1}): into h0_t from step t + 1
      cols_product(w.wh0, d0, r);
      store_at<kCl>(Q + 2 * L::kPartK, scatter_rows(r, pl.lane), mine, s, remote);
    }
    pass_barrier<kCl>();
  }
  {  // dz0_0 from pass 0's partials
    const float* P = s + L::kSPart + ph * L::kPartBuf;
    const float r0 = T > 1 ? sum_tiles<L::kTilesB>(P + 2 * L::kPartK, c) : 0.f;
    if (keeps) store_hist<kCl>(D0, rD0, c, tanh_back(__fadd_rn(sum_tiles<L::kTilesB>(P + L::kPartK, c), r0), H0[c]));
  }
  pass_barrier<kCl>();  // every block's D histories in place
  // the update: wh0 by h0_{t-1} x dz0_t (t >= 1), wx1 by h0_t x dz1_t, wh1 by h1_{t-1} x dz1_t (t >= 1)
  update_block(w.wh0, H0, 1, D0, 1, T, lr, pl.i0(), pl.j0());
  update_block(w.wx1, H0, 0, D1, 0, T, lr, pl.i0(), pl.j0());
  update_block(w.wh1, H1, 1, D1, 1, T, lr, pl.i0(), pl.j0());
  tid = fresh_tid();
  if (tid < kH) {  // wx0 by x_t dz0_t, b0 by dz0_t (every block alike)
    float gx = 0.f, gb = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      const float d = D0[t * kH + tid];
      gx = fmaf(x[t], d, gx);
      gb = __fadd_rn(gb, d);
    }
    s[L::kSWx0 + tid] = sgd(s[L::kSWx0 + tid], lr, gx);
    s[L::kSB0 + tid] = sgd(s[L::kSB0 + tid], lr, gb);
  } else if (tid < 2 * kH) {  // b1 by dz1_t
    float gb = 0.f;
    for (int t = T - 1; t >= 0; --t) gb = __fadd_rn(gb, D1[t * kH + tid - kH]);
    s[L::kSB1 + tid - kH] = sgd(s[L::kSB1 + tid - kH], lr, gb);
  } else {  // w_out[i][k] by h1_{T-1}[i] dlogits[k]
    const int e = tid - 2 * kH, i = e >> 1;
    s[L::kSWout + e] = sgd(s[L::kSWout + e], lr, __fmul_rn(H1[(T - 1) * kH + i], s[L::kSMisc + (e & 1)]));
  }
  if (tid < 2) s[L::kSBout + tid] = sgd(s[L::kSBout + tid], lr, s[L::kSMisc + tid]);
  __syncthreads();
  return s[L::kSMisc + 2];  // read by thread 0, which wrote it
}

template <int kCl>
__global__ void __launch_bounds__(kThreadsRnn, 1) rnn_chain_kernel(RnnArgs a) {
  using L = Split<kCl>;
  extern __shared__ __align__(16) float s[];
  const int tid = threadIdx.x;
  int rank = 0;
  float* remote = nullptr;  // the other block's shared memory
  if constexpr (kCl == 2) {
    cg::cluster_group cl = cg::this_cluster();
    rank = static_cast<int>(cl.block_rank());
    remote = cl.map_shared_rank(s, rank ^ 1);
  }
  const Place<kCl> pl(tid, rank);
  Weights<L::kColsT> w;
  load_block(w.wh0, a.w[1], pl.i0(), pl.j0());
  load_block(w.wx1, a.w[3], pl.i0(), pl.j0());
  load_block(w.wh1, a.w[4], pl.i0(), pl.j0());
  if (tid < kH) {
    s[L::kSWx0 + tid] = a.w[0][tid];
    s[L::kSB0 + tid] = a.w[2][tid];
    s[L::kSB1 + tid] = a.w[5][tid];
  } else if (tid < 3 * kH) {
    s[L::kSWout + tid - kH] = a.w[6][tid - kH];
  }
  if (tid < 2) s[L::kSBout + tid] = a.w[7][tid];
  const int T = a.T;
  // the histories: in shared memory, or in the scratch, a part each block; each kRows rows (a constant
  // stride: no register holds the four places)
  constexpr int kRows = (L::kShared ? L::kSharedT : kMaxT) * kH;
  float* hist = L::kShared ? s + L::kSHist : a.scratch + rank * 4 * kRows;
  float *H0 = hist, *H1 = hist + kRows, *D0 = hist + 2 * kRows, *D1 = hist + 3 * kRows;
  float *rD0 = nullptr, *rD1 = nullptr;  // the other block's D0, D1
  if constexpr (kCl == 2) {
    float* other = L::kShared ? remote + L::kSHist : a.scratch + (rank ^ 1) * 4 * kRows;
    rD0 = other + 2 * kRows;
    rD1 = other + 3 * kRows;
  }
  // the last fired position (0 the window-start anchor, q + 1 step q), in shared memory, read once a step: a
  // register held across the step makes the one-block kernel spill at its 128 a thread
  int* fire_at = reinterpret_cast<int*>(s + L::kSMisc + 3);
  if (tid == 0) *fire_at = 0;
  pass_barrier<kCl>();  // both blocks of a cluster run before either stores to the other's shared memory
  int ph = 0;    // the partial buffer of the last pass
  for (int p = 0; p < a.S; ++p) {
    const int gate = a.gates[p];
    const int fire = *fire_at;
    if (gate & kLearn) {
      const float loss = sgd_step<kCl>(s, remote, a.pre + static_cast<int64_t>(p) * T, T,
                                       a.lab[static_cast<int64_t>(p) * a.cols + fire], a.lr, H0, H1, D0, D1, rD0,
                                       rD1, w, pl, ph);
      if (tid == 0 && rank == 0) a.loss[p] = loss;
    } else if (tid == 0 && rank == 0) {
      a.loss[p] = 0.f;
    }
    bool want = false;
    if (gate & kFallback) {
      want = a.fb[static_cast<int64_t>(p) * a.cols + fire] != 0;
    } else if (gate & kDecide) {
      float l0, l1, hl;
      forward<kCl>(s, remote, a.post + static_cast<int64_t>(p) * T, T, H0, H1, w, pl, ph, l0, l1, hl);
      want = !(l0 != l0) && ((l1 != l1) || l1 > l0);  // argmax == 1: first index on a tie, NaN the maximum
    }
    if (gate & (kDecide | kFallback)) {  // a learn ends on a barrier; a decision gets one before fire is read
      if (tid == 0 && want) *fire_at = p + 1;
      __syncthreads();
    }
    if (tid == 0 && rank == 0) a.want[p] = want;
  }
  if (a.out != nullptr) {  // each block its columns of the matrices, block 0 the small leaves
    store_block(w.wh0, a.out + kOffWh0, pl.i0(), pl.j0());
    store_block(w.wx1, a.out + kOffWx1, pl.i0(), pl.j0());
    store_block(w.wh1, a.out + kOffWh1, pl.i0(), pl.j0());
    if (rank == 0) {
      if (tid < kH) {
        a.out[kOffWx0 + tid] = s[L::kSWx0 + tid];
        a.out[kOffB0 + tid] = s[L::kSB0 + tid];
        a.out[kOffB1 + tid] = s[L::kSB1 + tid];
      } else if (tid < 3 * kH) {
        a.out[kOffWout + tid - kH] = s[L::kSWout + tid - kH];
      }
      if (tid < 2) a.out[kOffBout + tid] = s[L::kSBout + tid];
    }
  }
  if constexpr (kCl == 2) cg::this_cluster().sync();  // no block leaves while the other may store to it
}

}  // namespace

namespace {  // the host side

// The variant a launch at window length T takes: one block while the
// histories fit in its shared memory, with them there, and past that a
// cluster of two with them in the global scratch.
int variant(int64_t T) { return T <= Split<1>::kSharedT ? 1 : 2; }

// 4 x 1,024 x 128 floats a block past T = 104 (the kMaxT stride: see the top of the file), else 0
int64_t scratch_floats(int64_t T) { return variant(T) == 1 ? 0 : 2 * 4 * kMaxT * kH; }

template <int kCl>
void* kernel_for() {
  return reinterpret_cast<void*>(rnn_chain_kernel<kCl>);
}

// One launch of the kCl variant on `stream`.
template <int kCl>
cudaError_t launch(const RnnArgs& a, cudaStream_t stream) {
  using L = Split<kCl>;
  void* fn = kernel_for<kCl>();
  static bool opted_in[64];  // the dynamic shared memory attribute, set once a device
  int device = 0;
  cudaGetDevice(&device);
  bool& done = opted_in[device];
  if (!done) {
    const cudaError_t rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(L::smem_bytes));
    if (rc != cudaSuccess) return rc;
    done = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCl, 1, 1);
  config.blockDim = dim3(kThreadsRnn, 1, 1);
  config.dynamicSmemBytes = L::smem_bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = kCl > 1 ? 1 : 0;
  void* args[] = {const_cast<RnnArgs*>(&a)};
  return cudaLaunchKernelExC(&config, fn, args);
}

// A launch's descriptor: 24 int64, the fields in this order.
enum RnnDesc {
  kDW = 0,              // the 8 leaves' pointers: wx0, wh0, b0, wx1, wh1, b1, w_out, b_out
  kDOut = 8,            // the final weights (kLeafFloats), or 0: no step learns
  kDLoss, kDWant,       // (S,) fp32 losses, (S,) bytes: the decisions
  kDScratch,            // the histories' scratch, or 0 (the plan's floats)
  kDOps, kDOpsBytes,    // the device buffer the operands are copied to, and their bytes
  kDPre, kDPost, kDLab, kDFb, kDGates,  // each operand's offset there in 4-byte words, or -1: none
  kDS, kDT, kDCols,     // steps, window length, label-table columns
  kDLr,                 // the learning rate's fp32 bits
  kDDevice,             // the device
  kDescLen
};
static_assert(kDescLen == 24, "the descriptor kernels/rnn.py fills");

// The operands' host staging: a ring of pinned slots a device, each with the
// event after the copy that last read it. A launch takes the next slot, waits
// on its event only if that copy has not run yet (4 launches queued behind
// it), and never waits on the stream otherwise.
constexpr int kSlots = 4;
struct Staging {
  std::mutex lock;
  void* host[kSlots] = {};
  int64_t bytes[kSlots] = {};
  cudaEvent_t done[kSlots] = {};
  int turn = 0;
};
Staging staging[64];

}  // namespace

// plan: 6 int64 for a launch at window length T on `device` (the variant T
// takes): dynamic shared memory bytes a block, the scratch floats it needs (0
// when the histories fit in shared memory), threads a block, blocks a
// cluster, and the kernel's registers a thread and local (spilled) bytes a
// thread.
REPRO_API int repro_rnn_chain_plan(int64_t T, int device, int64_t* plan) {
  if (T < 1 || T > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  const int cluster = variant(T);
  repro::use_device(device);
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, cluster == 1 ? kernel_for<1>() : kernel_for<2>());
  if (rc != cudaSuccess) return static_cast<int>(rc);
  plan[0] = static_cast<int64_t>(cluster == 1 ? Split<1>::smem_bytes : Split<2>::smem_bytes);
  plan[1] = scratch_floats(T);
  plan[2] = kThreadsRnn;
  plan[3] = cluster;
  plan[4] = attr.numRegs;
  plan[5] = static_cast<int64_t>(attr.localSizeBytes);
  return 0;
}

// S steps of one cluster's predictor at window length T (see the top of the
// file), described by `desc` (RnnDesc). The operands (pre, post, lab, fb,
// gates: fp32 windows, int32 tables, as the offsets say) are read from the
// host at `ops_host` before this returns, staged through a pinned slot and
// copied to the device buffer on `stream` ahead of the launch.
REPRO_API int repro_rnn_chain(const int64_t* desc, const void* ops_host, void* stream) {
  const int64_t S = desc[kDS], T = desc[kDT], cols = desc[kDCols], bytes = desc[kDOpsBytes];
  const int device = static_cast<int>(desc[kDDevice]);
  if (S < 1 || T < 1 || T > kMaxT || cols < 1 || S > (int64_t{1} << 30) || bytes < 0 || device < 0 || device >= 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cluster = variant(T);
  if (scratch_floats(T) > 0 && desc[kDScratch] == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  repro::use_device(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* ops = reinterpret_cast<char*>(desc[kDOps]);
  if (bytes > 0) {
    Staging& sg = staging[device];
    std::lock_guard<std::mutex> hold(sg.lock);
    const int i = sg.turn = (sg.turn + 1) % kSlots;
    if (sg.done[i] == nullptr) {
      const cudaError_t rc = cudaEventCreateWithFlags(&sg.done[i], cudaEventDisableTiming);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    } else if (cudaEventQuery(sg.done[i]) == cudaErrorNotReady) {
      const cudaError_t rc = cudaEventSynchronize(sg.done[i]);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    if (sg.bytes[i] < bytes) {
      if (sg.host[i] != nullptr) cudaFreeHost(sg.host[i]);
      sg.bytes[i] = 0;
      const int64_t want = bytes < 4096 ? 4096 : bytes * 2;
      const cudaError_t rc = cudaMallocHost(&sg.host[i], want);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      sg.bytes[i] = want;
    }
    std::memcpy(sg.host[i], ops_host, bytes);
    cudaError_t rc = cudaMemcpyAsync(ops, sg.host[i], bytes, cudaMemcpyHostToDevice, st);
    if (rc == cudaSuccess) rc = cudaEventRecord(sg.done[i], st);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  auto operand = [&](int k) { return desc[k] < 0 ? nullptr : ops + 4 * desc[k]; };
  const int64_t lr_bits = desc[kDLr];
  float lr;
  std::memcpy(&lr, &lr_bits, sizeof(float));
  RnnArgs a{{}, reinterpret_cast<const float*>(operand(kDPre)), reinterpret_cast<const float*>(operand(kDPost)),
            reinterpret_cast<const int*>(operand(kDLab)), reinterpret_cast<const int*>(operand(kDFb)),
            reinterpret_cast<const int*>(operand(kDGates)), reinterpret_cast<float*>(desc[kDOut]),
            reinterpret_cast<float*>(desc[kDLoss]), reinterpret_cast<unsigned char*>(desc[kDWant]),
            reinterpret_cast<float*>(desc[kDScratch]), static_cast<int>(S), static_cast<int>(T),
            static_cast<int>(cols), lr};
  for (int k = 0; k < 8; ++k) a.w[k] = reinterpret_cast<const float*>(desc[kDW + k]);
  const cudaError_t rc = cluster == 1 ? launch<1>(a, st) : launch<2>(a, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return repro::launch_status();
}
