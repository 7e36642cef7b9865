// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/paged_attn/kernel.py::
// paged_decode_pallas (its body is _kernel): one query token per slot
// attends over the slot's KV pages, named by its block-table row.
//
// Semantics (shared with kernels/paged_attn/ref.py):
//   * q (S, KV, G, D): G = H / KV query heads per kv head (GQA grouping);
//     k_pages / v_pages (P, page_len, KV, D); pos_pages (P, page_len) int32
//     absolute positions, -1 = empty; block_tables (S, M) int32 page ids,
//     -1 = unallocated; q_pos (S,) int32, -1 = inactive slot.
//   * key j of a named page is visible iff 0 <= pos_j <= q_pos.
//   * an inactive slot, or a head that sees no key, outputs exact zeros.
//   * q, the pages and out share one type (bf16 or f32); all
//     accumulation in f32.
//
// Design.  One thread block per (kv head, slot).  The TPU kernel walks
// the block-table columns as a sequential grid axis and carries (m, l,
// acc) in VMEM scratch across grid steps; here a loop inside the block
// walks the columns and keeps (m, l, acc) in shared memory.  A -1 column
// is skipped before any load, and an inactive slot returns at once, so
// the cost is O(allocated pages).  For each page the block stages the
// page's K and V rows of its kv head in shared memory (rows that are not
// visible are stored as zeros, so NaN bytes in empty entries cannot reach
// the sums), scores all G query heads against them, and runs the online
// softmax in f32 exactly as _kernel does.
//
// Bound.  Decoding one token is far below the card's balance point
// (~295 bf16 operations per byte): per visible key the kernel does 4*G*D
// operations on 2*D*sizeof(kv) bytes.  It is bound by the bytes of the KV
// pages the block tables reach, read once, against 3.35 TB/s.  The design
// reads each page of a kv head once per slot, coalesced along D, and
// writes nothing but the output; it does not yet overlap the next page's
// load with this page's arithmetic (cp.async / TMA) or split long
// contexts across blocks — that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // finite "minus infinity", as in _kernel
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ pos_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ q_pos, T* __restrict__ out,
                    int KV, int G, int D, int page_len, int M, float scale) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int GD = G * D;
  const int ldk = D + 1;  // padded K rows: score reads hit distinct banks

  extern __shared__ float smem[];
  float* q_s = smem;                     // (G, D)
  float* acc = q_s + GD;                 // (G, D)
  float* k_s = acc + GD;                 // (page_len, D + 1)
  float* v_s = k_s + page_len * ldk;     // (page_len, D)
  float* p_s = v_s + page_len * D;       // (G, page_len) scores, then probs
  float* m_s = p_s + G * page_len;       // (G,) running max
  float* l_s = m_s + G;                  // (G,) running denominator
  float* c_s = l_s + G;                  // (G,) rescale of this page
  int* ok_s = reinterpret_cast<int*>(c_s + G);  // (page_len,) visibility

  const int64_t qoff = ((int64_t)s * KV + h) * GD;
  const int qp = q_pos[s];
  if (qp < 0) {
    for (int i = tid; i < GD; i += kThreads) out[qoff + i] = from_f32<T>(0.f);
    return;
  }
  for (int i = tid; i < GD; i += kThreads) {
    q_s[i] = to_f32(q[qoff + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int* bt_row = block_tables + (int64_t)s * M;
  for (int mi = 0; mi < M; ++mi) {
    const int page = bt_row[mi];
    if (page < 0) continue;  // unallocated column: uniform across the block
    const int64_t row0 = (int64_t)page * page_len;

    for (int j = tid; j < page_len; j += kThreads) {
      const int p = pos_pages[row0 + j];
      ok_s[j] = (p >= 0) && (p <= qp);
    }
    __syncthreads();

    for (int i = tid; i < page_len * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int64_t src = ((row0 + j) * KV + h) * D + d;
      const bool ok = ok_s[j] != 0;
      k_s[j * ldk + d] = ok ? to_f32(k_pages[src]) : 0.f;
      v_s[j * D + d] = ok ? to_f32(v_pages[src]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < G * page_len; i += kThreads) {
      const int g = i / page_len;
      const int j = i - g * page_len;
      const float* qr = q_s + g * D;
      const float* kr = k_s + j * ldk;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      p_s[i] = ok_s[j] ? dot * scale : kNeg;
    }
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      float* pr = p_s + g * page_len;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int j = 0; j < page_len; ++j) m_new = fmaxf(m_new, pr[j]);
      const float corr = expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = 0; j < page_len; ++j) {
        const float e = ok_s[j] ? expf(pr[j] - m_new) : 0.f;
        pr[j] = e;
        sum += e;
      }
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
      c_s[g] = corr;
    }
    __syncthreads();

    for (int i = tid; i < GD; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = p_s + g * page_len;
      float a = acc[i] * c_s[g];
      for (int j = 0; j < page_len; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < GD; i += kThreads) {
    const float l = l_s[i / D];
    out[qoff + i] = from_f32<T>(l > 0.f ? acc[i] / l : 0.f);
  }
}

size_t smem_bytes(int G, int D, int page_len) {
  return sizeof(float) * (2 * (size_t)G * D + (size_t)page_len * (D + 1) +
                          (size_t)page_len * D + (size_t)G * page_len + 3 * G) +
         sizeof(int) * (size_t)page_len;
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* pos_pages, const void* block_tables, const void* q_pos,
           void* out, int S, int KV, int G, int D, int page_len, int M,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, D, page_len);
  auto kern = paged_decode_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(KV, S), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(pos_pages),
      static_cast<const int*>(block_tables), static_cast<const int*>(q_pos),
      static_cast<T*>(out), KV, G, D, page_len, M, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  q, the pages and out share one dtype:
// 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 = success); the caller raises.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* pos_pages,
                            const void* block_tables, const void* q_pos,
                            void* out, int S, int KV, int G, int D,
                            int page_len, int M, int dtype, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, pos_pages, block_tables,
                                 q_pos, out, S, KV, G, D, page_len, M, scale,
                                 st);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, pos_pages, block_tables, q_pos,
                         out, S, KV, G, D, page_len, M, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block needs, so the wrapper can refuse shapes
// beyond the card's 227 KB per block before launching.
extern "C" long long paged_decode_smem_bytes(int G, int D, int page_len) {
  return (long long)smem_bytes(G, D, page_len);
}
