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
// of pretrain_rnn (:258). The port's four entry points all launch this
// kernel (kernels/rnn.py): a per-event learn is S = 1 with a learn, a
// decision S = 1 with a decide, a coalesced window's chain S steps, and the
// pretraining S = 1,200 learn steps at lr 5e-3 with one label column. They
// run the same device code for a step, whatever S, so a chain is bit for bit
// the same steps as per-event launches.
//
// Weights: wx0 (1, 128), wh0 (128, 128), b0 (128), wx1 (128, 128), wh1
// (128, 128), b1 (128), w_out (128, 2), b_out (2): 49,794 floats, the leaves
// of init_rnn in that order. The kernel never writes its inputs: a launch
// with a learn step writes the final weights to a fresh flat buffer `out`, as
// the reference's functional update does (an expanded cluster's predictor
// shares its parent's weight tensors).
//
// Bound. One SGD step at T = 10 is about 3 MFLOP (9 T matrix-vector products
// and outer-product sums of 128 x 128) and about 0.4 MB of weights in and
// out; each step waits on the one before, and each time step of the
// recurrence on the last. One block is held to one SM's fp32 rate, about
// 0.5 TFLOP/s, so a step takes at least ~6 us and the 1,200-state
// pretraining at least ~7 ms. Spreading a step over several SMs (a cluster
// sharing the weights through distributed shared memory) is later work.
//
// Design: one block of 512 threads a launch.
//   - wh0, wx1 and wh1 live in shared memory for the whole launch (rows
//     padded to 129 floats: 198,144 B of the 227 KB), with the small leaves,
//     loaded once and written out once at the end.
//   - A matrix-vector product h @ W (forward) gives output column c to the
//     four threads (c, q), q = tid / 128, each summing its quarter of the
//     rows i = 32 q .. 32 q + 31 in ascending order with fmaf; the four
//     partials go through shared memory and are added as
//     ((q0 + q1) + q2) + q3. Lanes of a warp read consecutive columns of a
//     row: no bank conflict. The backward W @ dz gives row c to (c, q),
//     summing columns j = 32 q .. 32 q + 31 in ascending order; lanes read
//     consecutive rows of one column, which the padding puts on 32 banks.
//   - The two layers run as a wavefront: forward pass p computes layer 0's
//     step p and layer 1's step p - 1 (both read h0_{p-1}): T + 1 passes of
//     two barriers. The backward pass t computes wh1 @ dz1_t, wx1 @ dz1_t
//     and wh0 @ dz0_{t+1}, then dz1_{t-1} and dz0_t: T passes.
//   - No gradient buffer: each layer's inputs (h0_t, h1_t) and deltas (dz0_t,
//     dz1_t) are kept for the T steps, and after the backward each thread
//     applies W[i][j] <- W[i][j] - lr * sum_t a_t[i] dz_t[j] to the 96
//     elements it owns (column c, rows 32 q .. 32 q + 31 of each matrix),
//     each sum over t in descending order (autograd's visiting order). The
//     histories take 4 T 128 floats: in shared memory up to T = 12, beside
//     the weights, else in a global scratch the wrapper allocates.
//   - Every update is __fmul_rn then __fsub_rn (no FMA contraction in
//     updates and blends, the repo's rule); tanh_backward is
//     g * (1 - y * y), each op rounded once, as autograd takes it.
//   - Each thread owns fixed elements and every sum has the fixed order
//     above, so a launch gives the same bits every time. tanhf, expf and logf
//     are the CUDA library's, not numpy's or the CPU's: the kernel is held to
//     its plain version by tolerance, and by the bitwise rules between its
//     own entry points (PERF.md).
//   - T up to kMaxT = 1,024 (the largest fleet a path runs has 128 clients,
//     so k = max(top_k, cluster size) <= 128); the wrapper raises above it.
#include "common.cuh"

namespace {

constexpr int kH = 128;                     // hidden width (core/broadcast.py HIDDEN)
constexpr int kLdw = kH + 1;                // a shared weight row, padded for the column reads
constexpr int kThreadsRnn = 512;
constexpr int kQuarters = kThreadsRnn / kH;  // threads an output column or row
constexpr int kRowsQ = kH / kQuarters;       // rows (or columns) a thread sums: 32
constexpr int kMaxT = 1024;
constexpr int kSharedT = 12;                 // histories in shared memory up to this window length
constexpr int kLearn = 1, kDecide = 2, kFallback = 4;

// the leaves in the flat weight buffer, init_rnn's order
constexpr int kOffWx0 = 0, kOffWh0 = kOffWx0 + kH, kOffB0 = kOffWh0 + kH * kH, kOffWx1 = kOffB0 + kH,
              kOffWh1 = kOffWx1 + kH * kH, kOffB1 = kOffWh1 + kH * kH, kOffWout = kOffB1 + kH,
              kOffBout = kOffWout + 2 * kH, kLeafFloats = kOffBout + 2;
static_assert(kLeafFloats == 49794, "the RNN's 8 leaves");

// shared memory, in floats
constexpr int kMat = kH * kLdw;
constexpr int kSW0h = 0, kSW1x = kMat, kSW1h = 2 * kMat;
constexpr int kSWx0 = 3 * kMat, kSB0 = kSWx0 + kH, kSB1 = kSB0 + kH, kSWout = kSB1 + kH;  // w_out as [i][2]
constexpr int kSBout = kSWout + 2 * kH;           // 2, padded to 4
constexpr int kSPart = kSBout + 4;                // 3 products x 4 quarters x 128
constexpr int kSZero = kSPart + 3 * kQuarters * kH;  // h_{-1} = 0 and dz0_T = 0
constexpr int kSMisc = kSZero + kH;               // logits 2, dlogits 2, loss, (pad)
constexpr int kSHist = kSMisc + 8;                // H0, H1, D0, D1 when T <= kSharedT
static_assert(kSHist % 4 == 0 && kSZero % 4 == 0, "16-byte aligned vectors");

constexpr size_t smem_bytes(int64_t T) {
  return sizeof(float) * (kSHist + (T <= kSharedT ? 4 * T * kH : 0));
}
static_assert(smem_bytes(kSharedT) <= 232448, "fits the 227 KB a block can use");

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
  float* scratch;      // 4 T 128 floats when T > kSharedT
  int S, T, cols;
  float lr;
};

__device__ __forceinline__ float sum4(const float* part, int c) {
  return __fadd_rn(__fadd_rn(__fadd_rn(part[c], part[kH + c]), part[2 * kH + c]), part[3 * kH + c]);
}

// g * (1 - y * y): the gradient through y = tanh(z), each op rounded once
__device__ __forceinline__ float tanh_back(float g, float y) {
  return __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(y, y)));
}

// p - lr * g
__device__ __forceinline__ float sgd(float p, float lr, float g) { return __fsub_rn(p, __fmul_rn(lr, g)); }

// The forward over the window x (T,): H0[t] = h0_t, H1[t] = h1_t.
__device__ void forward(float* s, const float* x, int T, float* H0, float* H1) {
  const int tid = threadIdx.x, c = tid & (kH - 1), q = tid >> 7;
  const float* zero = s + kSZero;
  for (int p = 0; p <= T; ++p) {
    const float* h0 = p >= 1 ? H0 + (p - 1) * kH : zero;  // h0_{p-1}: layer 0's state, layer 1's input
    const float* h1 = p >= 2 ? H1 + (p - 2) * kH : zero;  // h1_{p-2}: layer 1's state
    float a0 = 0.f, ax = 0.f, ah = 0.f;
    const int i0 = q * kRowsQ;
#pragma unroll 8
    for (int r = 0; r < kRowsQ; ++r) {
      const int i = i0 + r;
      const float hv = h0[i], gv = h1[i];
      a0 = fmaf(hv, s[kSW0h + i * kLdw + c], a0);
      ax = fmaf(hv, s[kSW1x + i * kLdw + c], ax);
      ah = fmaf(gv, s[kSW1h + i * kLdw + c], ah);
    }
    s[kSPart + q * kH + c] = a0;
    s[kSPart + (kQuarters + q) * kH + c] = ax;
    s[kSPart + (2 * kQuarters + q) * kH + c] = ah;
    __syncthreads();
    if (tid < kH) {
      if (p < T) {  // h0_p = tanh(x_p wx0 + h0_{p-1} @ wh0 + b0)
        const float z = __fadd_rn(__fadd_rn(__fmul_rn(x[p], s[kSWx0 + c]), sum4(s + kSPart, c)), s[kSB0 + c]);
        H0[p * kH + c] = tanhf(z);
      }
    } else if (tid < 2 * kH) {
      if (p >= 1) {  // h1_{p-1} = tanh(h0_{p-1} @ wx1 + h1_{p-2} @ wh1 + b1)
        const float z = __fadd_rn(__fadd_rn(sum4(s + kSPart + kQuarters * kH, c),
                                            sum4(s + kSPart + 2 * kQuarters * kH, c)), s[kSB1 + c]);
        H1[(p - 1) * kH + c] = tanhf(z);
      }
    }
    __syncthreads();
  }
}

// logits = h @ w_out + b_out into s[kSMisc], one warp a logit: lane l sums
// rows l, l + 32, l + 64, l + 96 in that order, then a butterfly of shuffles.
__device__ void logits(float* s, const float* h) {
  const int tid = threadIdx.x, lane = tid & 31, k = tid >> 5;
  if (k < 2) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kH / 32; ++r) {
      const int i = lane + 32 * r;
      acc = fmaf(h[i], s[kSWout + 2 * i + k], acc);
    }
    acc = repro::warp_sum(acc);
    if (lane == 0) s[kSMisc + k] = __fadd_rn(acc, s[kSBout + k]);
  }
  __syncthreads();
}

// W[i][j] <- W[i][j] - lr * sum_{t = T-1 .. t_lo} A[t - lag][i] * D[t][j] for
// the 32 rows of column j this thread owns. A's rows are 16-byte aligned.
__device__ void update_matrix(float* W, const float* A, int lag, const float* D, int t_lo, int T, float lr) {
  const int j = threadIdx.x & (kH - 1), i0 = (threadIdx.x >> 7) * kRowsQ;
  float acc[kRowsQ];
#pragma unroll
  for (int r = 0; r < kRowsQ; ++r) acc[r] = 0.f;
  for (int t = T - 1; t >= t_lo; --t) {
    const float d = D[t * kH + j];
    const float4* a = reinterpret_cast<const float4*>(A + (t - lag) * kH + i0);
#pragma unroll
    for (int v = 0; v < kRowsQ / 4; ++v) {
      const float4 x = a[v];
      acc[4 * v] = fmaf(x.x, d, acc[4 * v]);
      acc[4 * v + 1] = fmaf(x.y, d, acc[4 * v + 1]);
      acc[4 * v + 2] = fmaf(x.z, d, acc[4 * v + 2]);
      acc[4 * v + 3] = fmaf(x.w, d, acc[4 * v + 3]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsQ; ++r) {
    float* w = W + (i0 + r) * kLdw + j;
    *w = sgd(*w, lr, acc[r]);
  }
}

// One SGD step on -log_softmax(logits(x))[label]; returns through s[kSMisc + 4] the loss.
__device__ void sgd_step(float* s, const float* x, int T, int label, float lr, float* H0, float* H1, float* D0,
                         float* D1) {
  const int tid = threadIdx.x, c = tid & (kH - 1), q = tid >> 7;
  forward(s, x, T, H0, H1);
  const float* hl = H1 + (T - 1) * kH;  // h1_{T-1}
  logits(s, hl);
  if (tid == 0) {  // log_softmax as the CPU takes it: (l - max) - log(sum exp(l - max)); d = softmax - onehot
    const float l0 = s[kSMisc], l1 = s[kSMisc + 1], m = fmaxf(l0, l1);
    const float lse = logf(__fadd_rn(expf(__fsub_rn(l0, m)), expf(__fsub_rn(l1, m))));
    const float lp0 = __fsub_rn(__fsub_rn(l0, m), lse), lp1 = __fsub_rn(__fsub_rn(l1, m), lse);
    s[kSMisc + 2] = __fsub_rn(expf(lp0), label == 0 ? 1.f : 0.f);
    s[kSMisc + 3] = __fsub_rn(expf(lp1), label == 1 ? 1.f : 0.f);
    s[kSMisc + 4] = -(label == 1 ? lp1 : lp0);
  }
  __syncthreads();
  const float dl0 = s[kSMisc + 2], dl1 = s[kSMisc + 3];
  if (tid < kH) {  // dz1_{T-1} = (w_out @ dlogits) through tanh
    const float g = __fadd_rn(__fmul_rn(s[kSWout + 2 * c], dl0), __fmul_rn(s[kSWout + 2 * c + 1], dl1));
    D1[(T - 1) * kH + c] = tanh_back(g, hl[c]);
  }
  __syncthreads();
  const float* zero = s + kSZero;
  for (int t = T - 1; t >= 0; --t) {
    const float* d1 = D1 + t * kH;                          // dz1_t
    const float* d0 = t + 1 < T ? D0 + (t + 1) * kH : zero;  // dz0_{t+1}
    float r1 = 0.f, u = 0.f, r0 = 0.f;
    const int j0 = q * kRowsQ;
#pragma unroll 8
    for (int r = 0; r < kRowsQ; ++r) {
      const int j = j0 + r;
      const float a = d1[j], b = d0[j];
      r1 = fmaf(s[kSW1h + c * kLdw + j], a, r1);  // (wh1 @ dz1_t)[c]: into h1_{t-1}
      u = fmaf(s[kSW1x + c * kLdw + j], a, u);    // (wx1 @ dz1_t)[c]: into h0_t from layer 1
      r0 = fmaf(s[kSW0h + c * kLdw + j], b, r0);  // (wh0 @ dz0_{t+1})[c]: into h0_t from step t + 1
    }
    s[kSPart + q * kH + c] = r1;
    s[kSPart + (kQuarters + q) * kH + c] = u;
    s[kSPart + (2 * kQuarters + q) * kH + c] = r0;
    __syncthreads();
    if (tid < kH) {
      if (t >= 1) D1[(t - 1) * kH + c] = tanh_back(sum4(s + kSPart, c), H1[(t - 1) * kH + c]);
    } else if (tid < 2 * kH) {
      const float g = __fadd_rn(sum4(s + kSPart + kQuarters * kH, c), sum4(s + kSPart + 2 * kQuarters * kH, c));
      D0[t * kH + c] = tanh_back(g, H0[t * kH + c]);
    }
    __syncthreads();
  }
  // the update: wh0 by h0_{t-1} x dz0_t (t >= 1), wx1 by h0_t x dz1_t, wh1 by h1_{t-1} x dz1_t (t >= 1)
  update_matrix(s + kSW0h, H0, 1, D0, 1, T, lr);
  update_matrix(s + kSW1x, H0, 0, D1, 0, T, lr);
  update_matrix(s + kSW1h, H1, 1, D1, 1, T, lr);
  if (tid < kH) {  // wx0 by x_t dz0_t, b0 by dz0_t
    float gx = 0.f, gb = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      const float d = D0[t * kH + c];
      gx = fmaf(x[t], d, gx);
      gb = __fadd_rn(gb, d);
    }
    s[kSWx0 + c] = sgd(s[kSWx0 + c], lr, gx);
    s[kSB0 + c] = sgd(s[kSB0 + c], lr, gb);
  } else if (tid < 2 * kH) {  // b1 by dz1_t
    float gb = 0.f;
    for (int t = T - 1; t >= 0; --t) gb = __fadd_rn(gb, D1[t * kH + c]);
    s[kSB1 + c] = sgd(s[kSB1 + c], lr, gb);
  } else {  // w_out[i][k] by h1_{T-1}[i] dlogits[k]
    const int e = tid - 2 * kH, i = e >> 1;
    s[kSWout + e] = sgd(s[kSWout + e], lr, __fmul_rn(hl[i], (e & 1) ? dl1 : dl0));
  }
  if (tid < 2) s[kSBout + tid] = sgd(s[kSBout + tid], lr, tid ? dl1 : dl0);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreadsRnn, 1) rnn_chain_kernel(RnnArgs a) {
  extern __shared__ __align__(16) float s[];
  const int tid = threadIdx.x;
  for (int e = tid; e < kH * kH; e += kThreadsRnn) {
    const int i = e >> 7, j = e & (kH - 1);
    s[kSW0h + i * kLdw + j] = a.w[1][e];
    s[kSW1x + i * kLdw + j] = a.w[3][e];
    s[kSW1h + i * kLdw + j] = a.w[4][e];
  }
  if (tid < kH) {
    s[kSWx0 + tid] = a.w[0][tid];
    s[kSB0 + tid] = a.w[2][tid];
    s[kSB1 + tid] = a.w[5][tid];
    s[kSZero + tid] = 0.f;
  } else if (tid < 3 * kH) {
    s[kSWout + tid - kH] = a.w[6][tid - kH];
  }
  if (tid < 2) s[kSBout + tid] = a.w[7][tid];
  const int T = a.T;
  float* hist = T <= kSharedT ? s + kSHist : a.scratch;
  float *H0 = hist, *H1 = hist + T * kH, *D0 = hist + 2 * T * kH, *D1 = hist + 3 * T * kH;
  __syncthreads();
  int fire = 0;  // the last fired position: 0 the window-start anchor, q + 1 step q
  for (int p = 0; p < a.S; ++p) {
    const int gate = a.gates[p];
    if (gate & kLearn) {
      sgd_step(s, a.pre + static_cast<int64_t>(p) * T, T, a.lab[static_cast<int64_t>(p) * a.cols + fire], a.lr,
               H0, H1, D0, D1);
      if (tid == 0) a.loss[p] = s[kSMisc + 4];
    } else if (tid == 0) {
      a.loss[p] = 0.f;
    }
    bool want = false;
    if (gate & kFallback) {
      want = a.fb[static_cast<int64_t>(p) * a.cols + fire] != 0;
    } else if (gate & kDecide) {
      forward(s, a.post + static_cast<int64_t>(p) * T, T, H0, H1);
      logits(s, H1 + (T - 1) * kH);
      const float l0 = s[kSMisc], l1 = s[kSMisc + 1];
      want = !(l0 != l0) && ((l1 != l1) || l1 > l0);  // argmax == 1: first index on a tie, NaN the maximum
    }
    if (want) fire = p + 1;
    if (tid == 0) a.want[p] = want;
  }
  if (a.out != nullptr) {
    for (int e = tid; e < kH * kH; e += kThreadsRnn) {
      const int i = e >> 7, j = e & (kH - 1);
      a.out[kOffWh0 + e] = s[kSW0h + i * kLdw + j];
      a.out[kOffWx1 + e] = s[kSW1x + i * kLdw + j];
      a.out[kOffWh1 + e] = s[kSW1h + i * kLdw + j];
    }
    if (tid < kH) {
      a.out[kOffWx0 + tid] = s[kSWx0 + tid];
      a.out[kOffB0 + tid] = s[kSB0 + tid];
      a.out[kOffB1 + tid] = s[kSB1 + tid];
    } else if (tid < 3 * kH) {
      a.out[kOffWout + tid - kH] = s[kSWout + tid - kH];
    }
    if (tid < 2) a.out[kOffBout + tid] = s[kSBout + tid];
  }
}

}  // namespace

// plan: 2 int64, the launch's dynamic shared memory bytes and the scratch
// floats it needs (0 when the histories fit in shared memory), at window length T.
REPRO_API int repro_rnn_chain_plan(int64_t T, int64_t* plan) {
  if (T < 1 || T > kMaxT) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = static_cast<int64_t>(smem_bytes(T));
  plan[1] = T <= kSharedT ? 0 : 4 * T * kH;
  return 0;
}

// S steps of one cluster's predictor at window length T (see the top of the
// file). out, post and fb may be null where no step learns, decides or falls
// back; scratch must hold 4 T 128 floats when T > 12.
REPRO_API int repro_rnn_chain(const float* wx0, const float* wh0, const float* b0, const float* wx1,
                              const float* wh1, const float* b1, const float* w_out, const float* b_out,
                              const float* pre, const float* post, const int* lab, const int* fb,
                              const int* gates, float* out, float* loss, unsigned char* want, float* scratch,
                              int64_t S, int64_t T, int64_t cols, float lr, int device, void* stream) {
  if (S < 1 || T < 1 || T > kMaxT || cols < 1 || S > (int64_t{1} << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T > kSharedT && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  repro::use_device(device);
  static bool opted_in[64];  // the dynamic shared memory attribute, set once a device
  if (!opted_in[device]) {
    const cudaError_t rc = cudaFuncSetAttribute(rnn_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(smem_bytes(kSharedT)));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    opted_in[device] = true;
  }
  RnnArgs a{{wx0, wh0, b0, wx1, wh1, b1, w_out, b_out}, pre, post, lab, fb, gates, out, loss, want, scratch,
            static_cast<int>(S), static_cast<int>(T), static_cast<int>(cols), lr};
  rnn_chain_kernel<<<1, kThreadsRnn, smem_bytes(T), static_cast<cudaStream_t>(stream)>>>(a);
  return repro::launch_status();
}
