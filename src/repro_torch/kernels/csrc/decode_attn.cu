// Paged decode attention: one query per request over its block table.
//
// Port of the Pallas kernel repro/kernels/decode_attn.py:154
// (`paged_decode_attention`, body :117).  The TPU grid (B, h, nbt) streams
// every K/V block once per QUERY head; here one block serves a (request, KV
// head) pair and all m = h/g query heads of that group (one warp each) from
// one read of each K/V block.  The block walks the table only up to the
// block holding `pos` (keys j <= pos are valid), staging each K/V block in
// shared memory as fp32 with a padded row (conflict-free column reads), and
// keeps an online softmax in fp32 registers: lane j scores key j of a
// 32-key chunk, and each lane owns hd/32 output dims.  A row with no valid
// key finalizes to 0 (l clamped at 1e-30).  Table entries < 0 read block 0.
#include "common.cuh"

namespace {

constexpr int MAX_NI = 8;  // hd / 32 <= 8, i.e. hd <= 256

template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,
                                    const T* __restrict__ kp,
                                    const T* __restrict__ vp,
                                    const int* __restrict__ tables,
                                    const int* __restrict__ pos,
                                    T* __restrict__ out, int h, int g, int hd,
                                    int bs, int nbt, float scale) {
  extern __shared__ float sm[];
  const int ldk = hd + 1;
  float* Ks = sm;                 // [bs][hd + 1]
  float* Vs = Ks + bs * ldk;      // [bs][hd + 1]
  float* Qs = Vs + bs * ldk;      // [m][hd]
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int m = h / g;
  const int lane = threadIdx.x & 31;
  const int qh = threadIdx.x >> 5;   // this warp's query head in the group
  const int ni = hd / 32;

  const T* qb = q + (static_cast<size_t>(b) * h + kvh * m) * hd;
  for (int i = threadIdx.x; i < m * hd; i += blockDim.x)
    Qs[i] = repro::to_f(qb[i]);
  const int p = pos[b];
  const int nblk = p < 0 ? 0 : min(nbt, p / bs + 1);

  float acc[MAX_NI];
#pragma unroll
  for (int i = 0; i < MAX_NI; ++i) acc[i] = 0.f;
  float m_run = repro::NEG_INF, l_run = 0.f;
  const float* qrow = Qs + qh * hd;

  for (int ib = 0; ib < nblk; ++ib) {
    int bid = tables[static_cast<size_t>(b) * nbt + ib];
    bid = bid < 0 ? 0 : bid;
    __syncthreads();  // the previous block's K/V reads are done
    for (int i = threadIdx.x; i < bs * hd; i += blockDim.x) {
      const int j = i / hd, d = i - j * hd;
      const size_t off =
          ((static_cast<size_t>(bid) * bs + j) * g + kvh) * hd + d;
      Ks[j * ldk + d] = repro::to_f(kp[off]);
      Vs[j * ldk + d] = repro::to_f(vp[off]);
    }
    __syncthreads();
    for (int c = 0; c < bs; c += 32) {
      const int j = c + lane;
      const bool valid = j < bs && ib * bs + j <= p;
      float s = repro::NEG_INF;
      if (valid) {
        const float* kr = Ks + j * ldk;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qrow[d] * kr[d];
        s = dot * scale;
      }
      const float m_new = fmaxf(m_run, repro::warp_max(s));
      const float pj = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(fminf(m_run - m_new, 0.f));
      l_run = l_run * corr + repro::warp_sum(pj);
#pragma unroll
      for (int i = 0; i < MAX_NI; ++i) acc[i] *= corr;
      const int nj = min(32, bs - c);
      for (int jj = 0; jj < nj; ++jj) {
        const float pv = __shfl_sync(repro::FULL_MASK, pj, jj);
        const float* vr = Vs + (c + jj) * ldk + lane;
#pragma unroll
        for (int i = 0; i < MAX_NI; ++i)
          if (i < ni) acc[i] += pv * vr[32 * i];
      }
      m_run = m_new;
    }
  }
  const float l = fmaxf(l_run, 1e-30f);
  T* ob = out + (static_cast<size_t>(b) * h + kvh * m + qh) * hd + lane;
#pragma unroll
  for (int i = 0; i < MAX_NI; ++i)
    if (i < ni) ob[32 * i] = repro::from_f<T>(acc[i] / l);
}

template <typename T>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const int* tables, const int* pos, void* out, int B,
                     int h, int g, int hd, int bs, int nbt, float scale,
                     cudaStream_t stream) {
  const int m = h / g;
  const size_t smem =
      (2 * static_cast<size_t>(bs) * (hd + 1) + static_cast<size_t>(m) * hd) *
      sizeof(float);
  cudaError_t e = repro::allow_smem(paged_decode_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  paged_decode_kernel<T><<<dim3(B, g), 32 * m, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, pos, static_cast<T*>(out), h, g, hd,
      bs, nbt, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* pos, void* out, int B, int h,
                                   int g, int hd, int bs, int nbt,
                                   float scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (g <= 0 || h % g != 0 || h / g > 32 || hd % 32 != 0 ||
      hd > 32 * MAX_NI || bs <= 0 || nbt <= 0)
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == DT_F32)
    e = launch_t<float>(q, k_pool, v_pool, tb, ps, out, B, h, g, hd, bs, nbt, scale, s);
  else if (dtype == DT_BF16)
    e = launch_t<__nv_bfloat16>(q, k_pool, v_pool, tb, ps, out, B, h, g, hd, bs, nbt, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
