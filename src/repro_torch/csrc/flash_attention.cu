// Position-safe, block-skipping GQA flash attention forward: out and lse.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:_flash_fwd_pallas
// (_flash_kernel), the attention of every moe_tx layer
// (repro/core/fusco.py:tx_attention) and, in the port, of the moe family's
// prefill and training step.  q (B, Sq, Hq, hd), k/v (B, Sk, Hkv, hd) with
// Hq % Hkv == 0, and int32 positions (Sq,) / (Sk,); out (B, Sq, Hq, hd) in
// q's dtype and the log-sum-exp (B, Hq, Sq) in float32.  Masking comes from
// the actual positions (causal: kpos <= qpos; window: qpos - kpos < window),
// so the shifted query stripe of an EP lane (positions lane*S/ep + arange)
// is right.
//
// Bound on the H100: bytes.  At the moe_tx prefill shape (B 8, S 512, Hq 16,
// Hkv 4, hd 64, bf16) it must read q 8 MiB, k and v 2 MiB each and write out
// 8 MiB and lse 0.25 MiB: ~21 MB, ~6.3 us at 3.35 TB/s, against ~4.3 GFLOP
// of causally visible work, ~4.4 us at 989 TFLOP/s.
//
// Three forms.  bf16, what serving and training run, goes to the Hopper form
// (flash_fwd_wgmma: TMA, an mbarrier ring, wgmma) at hd 64 and 128 and every
// group size up to 64: every full-width path.  The bf16 shapes it refuses
// (the reduced models' hd 16 and 32) go to the tensor-core form
// (flash_fwd_tc, mma.sync) through a C entry of their own; the wrapper
// chooses by shape.  float32, which the reduced models' card-vs-CPU checks
// run, stays on FMA on the CUDA cores (flash_fwd): tf32 would round the
// scores to ~3 digits.
//
// Skipping: the TPU kernel scalar-prefetched per-block position bounds; here
// a block computes min/max of its own query positions and skips a kv tile
// only when the bounds prove every entry masked (causal: min kpos > max
// qpos; window: min qpos - max kpos >= window).  Otherwise each entry is
// masked from the actual positions, the ragged edge of Sk included.
//
// A masked entry scores -1e30, as in the Pallas kernel, so a row whose first
// visible key comes in a later tile carries weight 1 on masked (zeroed or
// real) values until that key rescales it by exp(-1e30 - m) = 0.  Rows that
// see no key at all come from no path of the system: their output is
// unspecified.
//
// FMA form (f32): one block of 256 threads per (batch row, kv head,
// tile of query rows), where the rows are the (query, head-in-group) pairs of
// that kv head, so each k/v tile is loaded into shared memory once for all G
// query heads that read it.  The Pallas grid's sequential kv axis becomes a
// loop inside the block; the running max, sum and the output accumulator stay
// in float32 registers, and the output and lse are written once.  A row is
// held by hd/32 threads (one for hd <= 32), each with 32 (or hd) dims of q
// and of the accumulator, reduced by warp shuffles; scores and the product
// with v run with FMA in float32.  Each block reads its q rows once and each
// visible k/v tile once.  The tile test runs as two __syncthreads_or over
// the tile's positions.
#include "common.cuh"
#include "hopper.cuh"

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;  // keys per online-softmax update
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Geo {
  static constexpr int TPR = HD >= 64 ? HD / 32 : 1;  // threads per row
  static constexpr int DPT = HD / TPR;                // dims per thread
  static constexpr int C4 = DPT / 4;                  // float4 chunks per thread
  static constexpr int CH4 = HD / 4;                  // float4 chunks per key
  static constexpr int ROWS = kThreads / TPR;         // query rows per block
  static constexpr int BK = 4096 / HD;                // keys per kv tile
  static_assert(BK % kChunk == 0 && BK <= kThreads, "kv tile");
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ qpos,
              const int* __restrict__ kpos, float* __restrict__ out,
              float* __restrict__ lse, int sq, int sk, int hq, int hkv,
              int causal, int window) {
  using Gm = Geo<HD>;
  constexpr int TPR = Gm::TPR, C4 = Gm::C4, CH4 = Gm::CH4, BK = Gm::BK;
  __shared__ float4 sk4[BK * CH4];
  __shared__ float4 sv4[BK * CH4];
  __shared__ int skpos[BK];
  __shared__ int sqmin, sqmax;

  const int g = hq / hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int tid = threadIdx.x;
  const int t = tid % TPR;  // this thread's share of its row
  const int row = blockIdx.x * Gm::ROWS + tid / TPR;  // (query, head in group)
  const bool valid = row < sq * g;
  const int i = valid ? row / g : sq - 1;
  const int h = hk * g + (valid ? row % g : 0);
  const int my_qpos = qpos[i];
  const float scale_log2 = rsqrtf(static_cast<float>(HD)) * kLog2e;

  if (tid == 0) {
    sqmin = INT_MAX;
    sqmax = INT_MIN;
  }
  __syncthreads();
  if (valid && t == 0) {
    atomicMin(&sqmin, my_qpos);
    atomicMax(&sqmax, my_qpos);
  }
  __syncthreads();
  const int qmax = sqmax;
  // a key can be within the window of some query only if kpos > this
  const long long wlo =
      window > 0 ? static_cast<long long>(sqmin) - window : LLONG_MIN;

  // chunk c of this thread holds dims (c * TPR + t) * 4 .. + 3 of the row,
  // so the TPR threads of a row read neighbouring 16-byte words of a key
  float qr[4 * C4], acc[4 * C4];
  const float* qrow = q + (static_cast<size_t>(b) * sq + i) * hq * HD +
                  static_cast<size_t>(h) * HD;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    const float4 x = load4(qrow + (c * TPR + t) * 4);
    qr[4 * c] = x.x;
    qr[4 * c + 1] = x.y;
    qr[4 * c + 2] = x.z;
    qr[4 * c + 3] = x.w;
    acc[4 * c] = acc[4 * c + 1] = acc[4 * c + 2] = acc[4 * c + 3] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    bool c_vis = false, w_vis = false;
    if (tid < BK) {
      const int j = k0 + tid;
      const int p = j < sk ? kpos[j] : 0;
      skpos[tid] = p;
      c_vis = j < sk && (!causal || p <= qmax);
      w_vis = j < sk && static_cast<long long>(p) > wlo;
    }
    // min kpos <= max qpos, and min qpos - max kpos < window
    const int vis_c = __syncthreads_or(c_vis);
    const int vis_w = __syncthreads_or(w_vis);
    if (!(vis_c && vis_w)) continue;

    for (int e = tid; e < BK * CH4; e += kThreads) {
      const int j = k0 + e / CH4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (j < sk) {
        const size_t off = ((static_cast<size_t>(b) * sk + j) * hkv + hk) * HD +
                           (e % CH4) * 4;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      sk4[e] = kx;
      sv4[e] = vx;
    }
    __syncthreads();

    const int n_keys = min(BK, sk - k0);
    for (int jc = 0; jc < n_keys; jc += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int jl = jc + jj;
        const float4* kr = sk4 + jl * CH4;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 kx = kr[c * TPR + t];
          dot = fmaf(qr[4 * c], kx.x, dot);
          dot = fmaf(qr[4 * c + 1], kx.y, dot);
          dot = fmaf(qr[4 * c + 2], kx.z, dot);
          dot = fmaf(qr[4 * c + 3], kx.w, dot);
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const int p = skpos[jl];
        bool ok = jl < n_keys;
        if (causal) ok = ok && p <= my_qpos;
        if (window > 0)
          ok = ok && static_cast<long long>(my_qpos) - p < window;
        s[jj] = ok ? dot * scale_log2 : kNegInf;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < 4 * C4; ++d) acc[d] *= corr;
      m = m_new;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float pj = exp2f(s[jj] - m);
        l += pj;
        const float4* vr = sv4 + (jc + jj) * CH4;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 vx = vr[c * TPR + t];
          acc[4 * c] = fmaf(pj, vx.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(pj, vx.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(pj, vx.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(pj, vx.w, acc[4 * c + 3]);
        }
      }
    }
    __syncthreads();  // the tile is read; the next one may overwrite it
  }

  if (!valid) return;
  const float ls = fmaxf(l, 1e-30f);
  const float inv = 1.f / ls;
  float* orow = out + (static_cast<size_t>(b) * sq + i) * hq * HD +
            static_cast<size_t>(h) * HD;
#pragma unroll
  for (int c = 0; c < C4; ++c)
    store4(orow + (c * TPR + t) * 4, acc[4 * c] * inv, acc[4 * c + 1] * inv,
           acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
  if (t == 0)
    lse[(static_cast<size_t>(b) * hq + h) * sq + i] = m * kLn2 + logf(ls);
}

// ---------------------------------------------------------------------------
// Tensor-core form (bf16): flash_fwd_tc, mma.sync m16n8k16 with f32
// accumulators.  It takes the bf16 shapes the Hopper form below refuses:
// head dims 16 and 32 (the reduced models').  Four warps, each owning 16 of
// the block's 64 (query, head-in-group) rows; k/v tiles of 64 keys in
// shared memory, rows padded by 16 bytes so that the fragment loads of the
// 8 rows of a quad hit distinct banks.  S = Q K^T per 8-key column tile,
// the online softmax on
// S's accumulator fragments (a row's 4 lanes combine by shuffles), then P
// times V with V's fragments loaded by ldmatrix.trans.  P is rounded to
// bf16 for the tensor cores, as in the Hopper form; the row sums and the
// accumulators stay f32.  Same skipping, masking and -1e30 sentinel as the
// FMA form.  A block loads each k/v tile with plain 16-byte loads and waits
// on a barrier before its warps compute.
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;  // query rows per block
constexpr int kTcKeys = 64;             // keys per kv tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kTcWarps * 32)
    flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ qpos, const int* __restrict__ kpos,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int sq, int sk, int hq, int hkv, int causal, int window) {
  constexpr int S = HD + 8;     // padded row of a k/v tile, in elements
  constexpr int V8 = HD / 8;    // 16-byte vectors per key row
  constexpr int KS = HD / 16;   // k-steps of Q K^T
  constexpr int NT = kTcKeys / 8;
  constexpr int DT = HD / 8;
  __shared__ __align__(16) __nv_bfloat16 sk_[kTcKeys * S];
  __shared__ __align__(16) __nv_bfloat16 sv_[kTcKeys * S];
  __shared__ int skpos[kTcKeys];
  __shared__ int sqmin, sqmax;

  const int g = hq / hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int quad = lane / 4, qi = lane % 4;
  const float scale_log2 = rsqrtf(static_cast<float>(HD)) * kLog2e;

  // this thread's two rows: quad and quad + 8 of its warp's 16
  int qp[2], hh[2], ii[2];
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = blockIdx.x * kTcRows + warp * 16 + quad + 8 * r;
    valid[r] = row < sq * g;
    ii[r] = valid[r] ? row / g : sq - 1;
    hh[r] = hk * g + (valid[r] ? row % g : 0);
    qp[r] = qpos[ii[r]];
  }
  if (tid == 0) {
    sqmin = INT_MAX;
    sqmax = INT_MIN;
  }
  __syncthreads();
  if (qi == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (valid[r]) {
        atomicMin(&sqmin, qp[r]);
        atomicMax(&sqmax, qp[r]);
      }
  }
  __syncthreads();
  const int qmax = sqmax;
  const long long wlo =
      window > 0 ? static_cast<long long>(sqmin) - window : LLONG_MIN;

  // Q's A fragments: rows quad / quad + 8, columns 2 qi (+1) and + 8
  unsigned qa[KS][4];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qrow[r] = q + (static_cast<size_t>(b) * sq + ii[r]) * hq * HD +
              static_cast<size_t>(hh[r]) * HD;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * qi;
    qa[ks][0] = *reinterpret_cast<const unsigned*>(qrow[0] + c);
    qa[ks][1] = *reinterpret_cast<const unsigned*>(qrow[1] + c);
    qa[ks][2] = *reinterpret_cast<const unsigned*>(qrow[0] + c + 8);
    qa[ks][3] = *reinterpret_cast<const unsigned*>(qrow[1] + c + 8);
  }

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's share

  for (int k0 = 0; k0 < sk; k0 += kTcKeys) {
    bool c_vis = false, w_vis = false;
    if (tid < kTcKeys) {
      const int j = k0 + tid;
      const int p = j < sk ? kpos[j] : 0;
      skpos[tid] = p;
      c_vis = j < sk && (!causal || p <= qmax);
      w_vis = j < sk && static_cast<long long>(p) > wlo;
    }
    const int vis_c = __syncthreads_or(c_vis);
    const int vis_w = __syncthreads_or(w_vis);
    if (!(vis_c && vis_w)) continue;

    for (int e = tid; e < kTcKeys * V8; e += kTcWarps * 32) {
      const int jl = e / V8, c = (e % V8) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
      if (k0 + jl < sk) {
        const size_t off =
            ((static_cast<size_t>(b) * sk + k0 + jl) * hkv + hk) * HD + c;
        kx = *reinterpret_cast<const uint4*>(k + off);
        vx = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sk_ + jl * S + c) = kx;
      *reinterpret_cast<uint4*>(sv_ + jl * S + c) = vx;
    }
    __syncthreads();

    const int n_keys = min(kTcKeys, sk - k0);
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sk_ + (nt * 8 + quad) * S + 2 * qi;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_bf16(s[nt], qa[ks],
                 *reinterpret_cast<const unsigned*>(kr + ks * 16),
                 *reinterpret_cast<const unsigned*>(kr + ks * 16 + 8));
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = nt * 8 + 2 * qi + (e & 1), r = e >> 1;
        const int p = skpos[jl];
        bool ok = jl < n_keys;
        if (causal) ok = ok && p <= qp[r];
        if (window > 0) ok = ok && static_cast<long long>(qp[r]) - p < window;
        s[nt][e] = ok ? s[nt][e] * scale_log2 : kNegInf;
        mx[r] = fmaxf(mx[r], s[nt][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      l[r] *= corr[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    // O += P V, 16 keys at a time: P's A fragments are S's accumulators
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const unsigned vrow = static_cast<unsigned>(
          __cvta_generic_to_shared(sv_ + (kk * 16 + lane % 16) * S));
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        unsigned b0, b1;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
            : "=r"(b0), "=r"(b1)
            : "r"(vrow + dt * 16));
        mma_bf16(o[dt], pa, b0, b1);
      }
    }
    __syncthreads();  // the tile is read; the next one may overwrite it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!valid[r]) continue;
    const float ls = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / ls;
    __nv_bfloat16* orow = out + (static_cast<size_t>(b) * sq + ii[r]) * hq * HD +
                          static_cast<size_t>(hh[r]) * HD;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<unsigned*>(orow + dt * 8 + 2 * qi) =
          pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    if (qi == 0)
      lse[(static_cast<size_t>(b) * hq + hh[r]) * sq + ii[r]] =
          m[r] * kLn2 + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// Hopper form (bf16): flash_fwd_wgmma, on the core of hopper.cuh.
//
// One CTA per (tile of Qc = 64 / G queries (rounded down) x G heads, kv
// head, batch row): for a fixed (b, hk) the G query heads of one query are
// neighbours in memory, so one 4-D TMA map (hd, Hq, Sq, B) cuts the tile as
// a (64 hd, G heads, Qc queries) box from head hk * G.  Its Qc G rows are
// the live rows of the 64-row wgmma M tile: all 64 where G divides 64, 60
// at G 5 and 6, 63 at G 7.  The rows past them are zeroed once and never
// leave the CTA (the store box and lse take the live rows alone), so every
// group size up to 64 runs the same kernel.  160 threads: one consumer
// warpgroup and one producer warp.  Q is loaded once per CTA; K and V tiles
// of 64 keys go by TMA (a map (hd, Hkv, Sk, B), so the ragged Sk edge reads
// zeros) into a ring of two stages, K and V on barriers of their own so
// that S = Q K^T starts while V is still landing.  64 keys a tile at both
// head dims: a CTA covers only Qc queries (8 to 16 at G 4 to 8), so a
// wider tile would add masked work on the diagonal, and 64 keys keep S at
// 32 f32 registers a thread.  CTAs are launched heaviest first: the last query
// tiles, which see the most keys, do not form the tail.
//
// The producer warp walks the kv tiles in order: its lanes reduce the tile's
// key positions to (min, max), it skips a tile the bounds prove masked for
// every row of the CTA, and for each tile it loads it writes the tile's
// positions, its index and a "wholly visible" bit into the stage before its
// arrival on the full barrier, then ends the sequence with a stage marked
// -1.  The consumers read the tile sequence from there, so producer and
// consumers agree on it by construction and no one waits on a tile that is
// never loaded.
//
// The consumer warpgroup: S (64 x 64, f32) = Q K^T on wgmma m64n64k16, both
// operands K-major in 128-byte-swizzled rows; scale, mask from the stage's
// positions (skipped for a wholly visible tile), and the online softmax on
// the accumulator fragments (a row's max and sum across the 4 lanes that
// hold it).  P is rounded to bf16 in registers (the reference's lax flash
// does the same, p.astype(v.dtype)) and is the register A operand of
// O += P V (m64n{64,128}k16), its fragments being S's accumulator layout;
// V is read MN-major through the transpose bit.  O, the row max and the row
// sum stay in f32 registers.  At the end O is written as bf16 into the Q
// tile (read for the last time by the last S product) and leaves by TMA
// stores of the Q boxes' shape; lse is written directly.
// Each visible K and V tile is read once per CTA, Q once, out written once.
//
// What holds it back (a per-CTA globaltimer trace, PERF.md): each CTA is a
// chain of latencies (Q and first-tile loads ~1.5 us, then ~1 us a tile
// for S, softmax and P V in turn), so the card is kept busy by CTAs side by
// side: four an SM at hd 64, two at hd 128.  Overlapping a tile's softmax
// with the next tile's S product, or a CTA of two consumer warpgroups, was
// slower (fewer CTAs an SM).
// ---------------------------------------------------------------------------

constexpr int kFlashRows = 64;     // (query, head-in-group) rows per CTA
// the queries a CTA covers at group size g <= kFlashRows; its live rows are
// flash_tile_queries(g) * g
__host__ __device__ constexpr int flash_tile_queries(int g) {
  return kFlashRows / g;
}
constexpr int kFlashKeys = 64;     // keys per kv tile
constexpr int kFlashThreads = 160;  // a consumer warpgroup, a producer warp
constexpr int kFlashStages64 = 2;  // ring depth at hd 64 (four CTAs an SM)
constexpr int kFlashStages128 = 2; // at hd 128
constexpr int kFlashFixed = 1024 + 256;  // alignment slack, barriers, tile table
// CTAs an SM must hold, which bounds the registers of each thread (a
// sub-partition holds 16384 of them): at hd 64 the consumer fits in the 96
// of four CTAs of 5 warps, at hd 128 (64 f32 of O a thread, ~143) two
constexpr int kFlashMinCtas64 = 4;
constexpr int kFlashMinCtas128 = 2;
// a stage: a K and a V tile, and the tile's key positions
constexpr int kFlashStage64 = 2 * kFlashKeys * 64 * 2 + kFlashKeys * 4;
constexpr int kFlashStage128 = 2 * kFlashKeys * 128 * 2 + kFlashKeys * 4;
constexpr int kFlashSmem64 =
    kFlashFixed + kFlashRows * 64 * 2 + kFlashStages64 * kFlashStage64;
constexpr int kFlashSmem128 =
    kFlashFixed + kFlashRows * 128 * 2 + kFlashStages128 * kFlashStage128;

template <int HD>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_v) {
  if constexpr (HD == 64)
    hopper::wgmma_m64n64k16_rs<1>(o, a, desc_v);
  else
    hopper::wgmma_m64n128k16_rs<1>(o, a, desc_v);
}

// S (64 x 64 keys, f32) = Q K^T, issued and committed as one wgmma group
// (not waited on): qw the Q tile, kt the K tile, both K-major in HD / 64
// boxes of 128-byte-swizzled rows.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[32],
                                             const unsigned char* qw,
                                             const unsigned char* kt) {
  using namespace hopper;
  if constexpr (!kProducts) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
  }
  fence_acc(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16 && kProducts; ++kk) {
    const int off = (kk / 4) * kBoxBytes + 32 * (kk % 4);
    wgmma_m64n64k16<0>(s, desc(qw + off, 16, 1024), desc(kt + off, 16, 1024),
                       kk != 0);
  }
  wgmma_commit();
}

// O += P V, issued and committed as one wgmma group: P the register A
// operand (pa), V (64 keys x HD) read MN-major from vt.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[4][4],
                                         const unsigned char* vt) {
  using namespace hopper;
  fence_acc(o);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4 && kProducts; ++ks)
    pv_product<HD>(o, pa[ks], desc(vt + 2048 * ks, kBoxBytes, 1024));
  wgmma_commit();
}

// The online softmax of one tile's scores s (row acc_row(t, i), key k0 +
// acc_col(t, i) of element i; info = tile index * 2 + wholly visible): scale
// to log2 units, mask from the tile's key positions kp unless wholly
// visible, the new row max m (across the 4 lanes of a row), the rescale
// corr of what came before, l rescaled and grown by this tile's share, and
// P in bf16 as wgmma A fragments: pa[ks][j] holds columns 16 ks + 8 (j / 2)
// + 2 (t % 4) and the next of row half j % 2, s[8 ks + 2 j] and the next.
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], uint32_t (&pa)[4][4], float (&corr)[2], float (&m)[2],
    float (&l)[2], const int (&qp)[2], const int* kp, int info, int sk,
    int causal, int window, float scale_log2, int t) {
  const int k0 = (info >> 1) * kFlashKeys;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
  if (!(info & 1)) {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jl = 8 * a + 2 * (t & 3) + c;
        const int p = kp[jl];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bool ok = k0 + jl < sk;
          if (causal) ok = ok && p <= qp[h];
          if (window > 0)
            ok = ok && static_cast<long long>(qp[h]) - p < window;
          if (!ok) s[4 * a + 2 * h + c] = kNegInf;
        }
      }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = exp2f(m[h] - m_new);
    l[h] *= corr[h];
    m[h] = m_new;
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 8 * ks + 2 * j;
      const float p0 = exp2f(s[e] - m[j & 1]);
      const float p1 = exp2f(s[e + 1] - m[j & 1]);
      l[j & 1] += p0 + p1;
      __nv_bfloat162 v = __floats2bfloat162_rn(p0, p1);
      pa[ks][j] = *reinterpret_cast<uint32_t*>(&v);
    }
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads, HD == 64 ? kFlashMinCtas64 : kFlashMinCtas128)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,
                    const int* __restrict__ qpos, const int* __restrict__ kpos,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int sq, int sk, int hq, int hkv, int causal, int window) {
  using namespace hopper;
  static_assert(HD == 64 || HD == 128, "head dims of the Hopper form");
  constexpr int kChunks = HD / 64;  // 64-wide boxes across hd
  constexpr int kStages = HD == 64 ? kFlashStages64 : kFlashStages128;
  constexpr int kTile = kFlashKeys * HD * 2;  // one K or V tile
  const int g = hq / hkv;
  const int live = flash_tile_queries(g) * g;  // rows the Q box fills
  const int hk = blockIdx.y, b = blockIdx.z;
  // the heaviest causal tiles (the last queries) first, for a shorter tail;
  // row0 / g is the tile's first query
  const int row0 = (gridDim.x - 1 - blockIdx.x) * live;
  const int rows = sq * g;
  const int tid = threadIdx.x;

  extern __shared__ __align__(1024) unsigned char smem_f[];
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem_f);  // [kStages]
  uint64_t* full_v = full_k + kStages;                      // [kStages]
  uint64_t* empty = full_v + kStages;                       // [kStages]
  uint64_t* q_full = empty + kStages;
  int* tile_of = reinterpret_cast<int*>(q_full + 1);        // [kStages]
  int* qbounds = tile_of + kStages;                         // min, max qpos
  const uint32_t s0 = smem_addr(smem_f);
  unsigned char* qs = smem_f + (((s0 + 256 + 1023) & ~1023u) - s0);
  unsigned char* ring = qs + kFlashRows * HD * 2;
  int* kpos_s = reinterpret_cast<int*>(ring + kStages * 2 * kTile);  // [kStages][64]

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty[i], 4);  // lane 0 of each consumer warp
    }
    mbar_init(q_full, 1);
    qbounds[0] = INT_MAX;
    qbounds[1] = INT_MIN;
    fence_barrier_init();
  }
  __syncthreads();
  if (tid < kFlashRows) {  // warps 0-3: this CTA's query positions
    const bool own = tid < live && row0 + tid < rows;
    const int p = own ? qpos[(row0 + tid) / g] : 0;
    const int lo = __reduce_min_sync(0xffffffffu, own ? p : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, own ? p : INT_MIN);
    if (tid % 32 == 0) {
      atomicMin(&qbounds[0], lo);
      atomicMax(&qbounds[1], hi);
    }
  }
  __syncthreads();
  const int qmin = qbounds[0], qmax = qbounds[1];

  if (tid >= 128) {  // the producer warp
    const int lane = tid - 128;
    if (lane == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&omap);
      if constexpr (kLoads) {
        mbar_expect_tx(q_full, live * HD * 2);  // the box's bytes, Sq edge too
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(qs + c * kBoxBytes, &qmap, q_full, 64 * c, hk * g,
                      row0 / g, b);
      } else {
        mbar_arrive(q_full);
      }
    }
    // a key is within the window of some query of the CTA only if kpos > wlo
    const long long wlo =
        window > 0 ? static_cast<long long>(qmin) - window : LLONG_MIN;
    int st = 0;
    uint32_t ph = 0;
    for (int k0 = 0; k0 < sk; k0 += kFlashKeys) {
      // keys k0 + lane and k0 + lane + 32; positions past Sk are never read
      const int j0 = k0 + lane, j1 = j0 + 32;
      const int p0 = j0 < sk ? kpos[j0] : 0, p1 = j1 < sk ? kpos[j1] : 0;
      const int lo = __reduce_min_sync(
          0xffffffffu, min(j0 < sk ? p0 : INT_MAX, j1 < sk ? p1 : INT_MAX));
      const int hi = __reduce_max_sync(
          0xffffffffu, max(j0 < sk ? p0 : INT_MIN, j1 < sk ? p1 : INT_MIN));
      // min kpos <= max qpos, and min qpos - max kpos < window
      if (!((!causal || lo <= qmax) && static_cast<long long>(hi) > wlo))
        continue;
      const bool whole =
          k0 + kFlashKeys <= sk && (!causal || hi <= qmin) &&
          (window <= 0 || static_cast<long long>(qmax) - lo < window);
      if (lane == 0) mbar_wait(&empty[st], ph ^ 1);
      __syncwarp();  // the stage is free: its positions may be written
      kpos_s[st * kFlashKeys + lane] = p0;
      kpos_s[st * kFlashKeys + lane + 32] = p1;
      __syncwarp();  // lane 0's arrival below publishes the whole warp's writes
      if (lane == 0) {
        tile_of[st] = (k0 / kFlashKeys) * 2 + (whole ? 1 : 0);
        unsigned char* kt = ring + st * 2 * kTile;
        if constexpr (kLoads) {
          mbar_expect_tx(&full_k[st], kTile);
          for (int c = 0; c < kChunks; ++c)
            tma_load_4d(kt + c * kBoxBytes, &kmap, &full_k[st], 64 * c, hk, k0,
                        b);
          mbar_expect_tx(&full_v[st], kTile);
          for (int c = 0; c < kChunks; ++c)
            tma_load_4d(kt + kTile + c * kBoxBytes, &vmap, &full_v[st], 64 * c,
                        hk, k0, b);
        } else {
          mbar_arrive(&full_k[st]);
          mbar_arrive(&full_v[st]);
        }
      }
      if (++st == kStages) {
        st = 0;
        ph ^= 1;
      }
    }
    if (lane == 0) {  // the end of the sequence
      mbar_wait(&empty[st], ph ^ 1);
      tile_of[st] = -1;
      mbar_arrive(&full_k[st]);
    }
    return;
  }

  // the consumer warpgroup
  const int t = tid, lane = t % 32;
  const float scale_log2 = rsqrtf(static_cast<float>(HD)) * kLog2e;
  int qp[2];  // the positions of the thread's rows, acc_row(t, 2 h)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = acc_row(t, 2 * h);
    qp[h] = r < live && row0 + r < rows ? qpos[(row0 + r) / g] : 0;
  }
  // the rows past the box's (64 mod G of them) are never loaded: zero
  // them once, so that no inf or NaN arises in rows no one reads
  if (live < kFlashRows) {
    for (int i = live * 8 + t; i < kFlashRows * 8; i += 128)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        *reinterpret_cast<uint4*>(qs + c * kBoxBytes + i * 16) =
            make_uint4(0, 0, 0, 0);
    fence_proxy_async();  // generic stores, read by wgmma (the async proxy)
    named_barrier(1, 128);
  }
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's share

  mbar_wait(q_full, 0);
  int st = 0;
  uint32_t ph = 0;
  float s[32], corr[2];
  uint32_t pa[4][4];
  for (;;) {  // each tile in turn: S, softmax, P V
    mbar_wait(&full_k[st], ph);
    const int info = tile_of[st];
    if (info < 0) break;
    const unsigned char* kt = ring + st * 2 * kTile;
    issue_scores<HD>(s, qs, kt);
    wgmma_wait<0>();
    fence_acc(s);
    softmax_tile(s, pa, corr, m, l, qp, kpos_s + st * kFlashKeys, info, sk,
                 causal, window, scale_log2, t);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    mbar_wait(&full_v[st], ph);
    issue_pv<HD>(o, pa, kt + kTile);
    wgmma_wait<0>();
    fence_acc(o);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) fence_regs(pa[ks]);
    if (lane == 0) mbar_arrive(&empty[st]);
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  // O goes out through the Q tile, which the last S product has read: bf16
  // into the 128-byte-swizzled layout the Q boxes came in (16-byte chunk c
  // of row r at chunk c ^ (r % 8)), then TMA stores of the same boxes, which
  // drop the rows past Sq
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int h = (i >> 1) & 1, r = acc_row(t, i), col = acc_col(t, i);
    const int cc = col % 64;
    *reinterpret_cast<__nv_bfloat162*>(
        qs + (col / 64) * kBoxBytes + r * 128 + (((cc >> 3) ^ (r & 7)) << 4) +
        (cc & 7) * 2) = __floats2bfloat162_rn(o[i] * inv[h], o[i + 1] * inv[h]);
  }
  fence_proxy_async();
  named_barrier(1, 128);
  if (t == 0) {
    for (int c = 0; c < kChunks; ++c)
      tma_store_4d(&omap, qs + c * kBoxBytes, 64 * c, hk * g, row0 / g, b);
    tma_store_wait_read();
  }
  if ((t & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + acc_row(t, 2 * h);
      if (acc_row(t, 2 * h) < live && r < rows)
        lse[(static_cast<size_t>(b) * hq + hk * g + r % g) * sq + r / g] =
            m[h] * kLn2 + logf(fmaxf(l[h], 1e-30f));
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* qpos,
                 const void* kpos, void* out, void* lse, int b, int sq, int sk,
                 int hq, int hkv, int causal, int window, cudaStream_t st) {
  const int g = hq / hkv;
  if (g > kFlashRows || sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int qc = flash_tile_queries(g);
  const uint64_t es = sizeof(__nv_bfloat16);
  const uint64_t qn[4] = {HD, static_cast<uint64_t>(hq),
                          static_cast<uint64_t>(sq), static_cast<uint64_t>(b)};
  const uint64_t qs[3] = {HD * es, hq * HD * es,
                          static_cast<uint64_t>(sq) * hq * HD * es};
  const uint32_t qbox[4] = {64, static_cast<uint32_t>(g),
                            static_cast<uint32_t>(qc), 1};
  const uint64_t kn[4] = {HD, static_cast<uint64_t>(hkv),
                          static_cast<uint64_t>(sk), static_cast<uint64_t>(b)};
  const uint64_t ks[3] = {HD * es, hkv * HD * es,
                          static_cast<uint64_t>(sk) * hkv * HD * es};
  const uint32_t kbox[4] = {64, 1, kFlashKeys, 1};
  CUtensorMap qm, km, vm, om;  // out has q's layout: the same boxes
  if (!(hopper::make_map_4d(&qm, q, qn, qs, qbox) &&
        hopper::make_map_4d(&km, k, kn, ks, kbox) &&
        hopper::make_map_4d(&vm, v, kn, ks, kbox) &&
        hopper::make_map_4d(&om, out, qn, qs, qbox)))
    return hopper::kErrTensorMap;
  constexpr int smem = HD == 64 ? kFlashSmem64 : kFlashSmem128;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // room for two CTAs an SM where registers allow
    err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + qc - 1) / qc), hkv, b);
  flash_fwd_wgmma<HD><<<grid, kFlashThreads, smem, st>>>(
      qm, km, vm, om, static_cast<const int*>(qpos),
      static_cast<const int*>(kpos),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), sq, sk, hq,
      hkv, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_fma(const void* q, const void* k, const void* v, const void* qpos,
               const void* kpos, void* out, void* lse, int b, int sq, int sk,
               int hq, int hkv, int causal, int window, cudaStream_t st) {
  const long long rows = static_cast<long long>(sq) * (hq / hkv);
  const dim3 grid(
      static_cast<unsigned>((rows + Geo<HD>::ROWS - 1) / Geo<HD>::ROWS), hkv, b);
  flash_fwd<HD><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<float*>(out),
      static_cast<float*>(lse), sq, sk, hq, hkv, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* qpos,
              const void* kpos, void* out, void* lse, int b, int sq, int sk,
              int hq, int hkv, int causal, int window, cudaStream_t st) {
  using T = __nv_bfloat16;
  const long long rows = static_cast<long long>(sq) * (hq / hkv);
  const dim3 grid(static_cast<unsigned>((rows + kTcRows - 1) / kTcRows), hkv,
                  b);
  flash_fwd_tc<HD><<<grid, kTcWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<T*>(out),
      static_cast<float*>(lse), sq, sk, hq, hkv, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor-core form: bf16 (dtype kBF16) only, hd 16, 32, 64 or 128, any
// group size; the wrapper sends it the bf16 shapes the Hopper form refuses
// (hd 16 and 32, the reduced models').
// The arguments are flash_attention_fwd's.
extern "C" int flash_attention_fwd_tc(const void* q, const void* k,
                                      const void* v, const void* qpos,
                                      const void* kpos, void* out, void* lse,
                                      int b, int sq, int sk, int hq, int hkv,
                                      int hd, int dtype, int causal,
                                      int window, void* stream) {
  if (b == 0 || sq == 0 || hq == 0) return static_cast<int>(cudaSuccess);
  if (dtype != repro::kBF16 || hkv <= 0 || hq % hkv != 0 || b > 65535 ||
      hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_tc<16>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                           causal, window, st);
    case 32:
      return launch_tc<32>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                           causal, window, st);
    case 64:
      return launch_tc<64>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                           causal, window, st);
    case 128:
      return launch_tc<128>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                            causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// window <= 0: no window.  Pointers are 16-byte aligned (the wrapper checks).
// dtype kBF16 takes the Hopper form, which needs hd 64 or 128, a group size
// Hq / Hkv of at most 64 and Sk >= 1 (else cudaErrorInvalidValue; a map TMA
// refuses gives hopper::kErrTensorMap); kF32 the FMA form, hd 16, 32, 64 or
// 128.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* kpos,
                                   void* out, void* lse, int b, int sq, int sk,
                                   int hq, int hkv, int hd, int dtype,
                                   int causal, int window, void* stream) {
  if (b == 0 || sq == 0 || hq == 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv != 0 || b > 65535 || hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16) {
    switch (hd) {
      case 64:
        return launch_wgmma<64>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq,
                                hkv, causal, window, st);
      case 128:
        return launch_wgmma<128>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq,
                                 hkv, causal, window, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != repro::kF32) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16:
      return launch_fma<16>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                            causal, window, st);
    case 32:
      return launch_fma<32>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                            causal, window, st);
    case 64:
      return launch_fma<64>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                            causal, window, st);
    case 128:
      return launch_fma<128>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                             causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
