// Position-safe, block-skipping GQA flash attention forward: out and lse.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:_flash_fwd_pallas
// (_flash_kernel), the attention of every moe_tx layer
// (repro/core/fusco.py:tx_attention) and, in the port, of the moe family's
// prefill.  q (B, Sq, Hq, hd), k/v (B, Sk, Hkv, hd) with Hq % Hkv == 0, and
// int32 positions (Sq,) / (Sk,); out (B, Sq, Hq, hd) in q's dtype and the
// log-sum-exp (B, Hq, Sq) in float32.  Masking comes from the actual
// positions (causal: kpos <= qpos; window: qpos - kpos < window), so the
// shifted query stripe of an EP lane (positions lane*S/ep + arange) is right.
//
// Bound on the H100: bytes.  At the moe_tx prefill shape (B 8, S 512, Hq 16,
// Hkv 4, hd 64, bf16) it must read q 8 MiB, k and v 2 MiB each and write out
// 8 MiB and lse 0.25 MiB: ~21 MB, ~6.3 us at 3.35 TB/s, against ~4.3 GFLOP
// of causally visible work, ~4.4 us at 989 TFLOP/s.
//
// Two forms, chosen by the element type at the one C entry below.  bf16, what
// serving runs, goes to the tensor cores (flash_fwd_tc, mma.sync).  float32,
// which the reduced models' card-vs-CPU check runs, stays on FMA on the CUDA
// cores (flash_fwd): tf32 would round the scores to ~3 digits.
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
// visible k/v tile once.
//
// Skipping: the TPU kernel scalar-prefetched per-block position bounds; here
// the block computes min/max of its own query positions and, per kv tile,
// skips the tile only when the bounds prove every entry masked
// (causal: min kpos > max qpos; window: min qpos - max kpos >= window), via
// two __syncthreads_or over the tile's positions.  Otherwise each entry is
// masked from the actual positions, the ragged edge of Sk included.
//
// A masked entry scores -1e30, as in the Pallas kernel, so a row whose first
// visible key comes in a later tile carries weight 1 on masked (zeroed or
// real) values until that key rescales it by exp(-1e30 - m) = 0.  Rows that
// see no key at all come from no path of the system: their output is
// unspecified.
#include "common.cuh"

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
// Tensor-core form (bf16): mma.sync m16n8k16 with f32 accumulators.  Four
// warps, each owning 16 of the block's 64 (query, head-in-group) rows; k/v
// tiles of 64 keys in shared memory, rows padded by 16 bytes so that the
// fragment loads of the 8 rows of a quad hit distinct banks.  S = Q K^T per
// 8-key column tile, the online softmax on S's accumulator fragments (a
// row's 4 lanes combine by shuffles), then P times V with V's fragments
// loaded by ldmatrix.trans.  P is rounded to bf16 for the tensor cores (the
// reference's lax flash does the same, p.astype(v.dtype)); the row sums and
// the accumulators stay f32.  Same skipping, masking and -1e30 sentinel as
// the FMA form.  Against the byte bound, what remains is latency: a block
// loads each k/v tile with plain 16-byte loads and waits on a barrier before
// its warps compute, with no copy in flight behind the compute (cp.async or
// TMA double buffering is the next step).
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

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, void* lse, int b, int sq, int sk,
           int hq, int hkv, int dtype, int causal, int window,
           cudaStream_t stream) {
  const long long rows = static_cast<long long>(sq) * (hq / hkv);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  float* ls = static_cast<float*>(lse);
  if (dtype == repro::kBF16) {
    const dim3 grid(static_cast<unsigned>((rows + kTcRows - 1) / kTcRows),
                    hkv, b);
    using T = __nv_bfloat16;
    flash_fwd_tc<HD><<<grid, kTcWarps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), qp, kp, static_cast<T*>(out), ls, sq, sk,
        hq, hkv, causal, window);
  } else if (dtype == repro::kF32) {
    const dim3 grid(static_cast<unsigned>((rows + Geo<HD>::ROWS - 1) /
                                          Geo<HD>::ROWS),
                    hkv, b);
    flash_fwd<HD><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qp, kp, static_cast<float*>(out), ls,
        sq, sk, hq, hkv, causal, window);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0: no window.  Pointers are 16-byte aligned (the wrapper checks).
// dtype kBF16 takes the tensor-core form, kF32 the FMA form.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* kpos,
                                   void* out, void* lse, int b, int sq, int sk,
                                   int hq, int hkv, int hd, int dtype,
                                   int causal, int window, void* stream) {
  if (b == 0 || sq == 0 || hq == 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv != 0 || b > 65535 || hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                        dtype, causal, window, st);
    case 32:
      return launch<32>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                        dtype, causal, window, st);
    case 64:
      return launch<64>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                        dtype, causal, window, st);
    case 128:
      return launch<128>(q, k, v, qpos, kpos, out, lse, b, sq, sk, hq, hkv,
                         dtype, causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
