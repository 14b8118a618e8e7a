// Fused non-causal multi-head self-attention for the vision towers, in
// three schedules of one function: one-block (`_mha_kernel`), split-key
// (`_mha_split_kernel`) and packed-pair (`_mha_packed_kernel`) of
// bayesvlm_tpu/models/attention_pallas.py. The kernel, its rounding
// points, its design and what bounds it are in csrc/attention.cuh.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include "attention.cuh"

namespace {

using namespace bvt_attn;

template <typename T>
int launch_schedule(const void* q, const void* k, const void* v, void* o, int B,
                    int seq, int heads, int head_dim, float scale, int schedule,
                    cudaStream_t stream) {
  switch (schedule) {
    case kOneBlock:
      return launch_head_dim<T, kOneBlock>(q, k, v, o, B, seq, heads, head_dim, scale,
                                           stream);
    case kSplitKey:
      return launch_head_dim<T, kSplitKey>(q, k, v, o, B, seq, heads, head_dim, scale,
                                           stream);
    case kPackedPair:
      return launch_head_dim<T, kPackedPair>(q, k, v, o, B, seq, heads, head_dim,
                                             scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory one block of `schedule` (0 one-block,
// 1 split-key, 2 packed-pair) needs for seq keys
long bvt_attention_smem_bytes(int seq, int head_dim, int schedule) {
  return bvt_attn::smem_floats(schedule, seq, head_dim) * (long)sizeof(float);
}

// the most dynamic shared memory a block of the current device may opt
// in to, or -1 when the device cannot be queried
int bvt_attention_smem_limit(void) {
  const int optin = bvt_attn::smem_optin();
  return optin < 0 ? -1 : optin;
}

// dtype: 0 = float32, 1 = bfloat16; scale multiplies the fp32 dot
// products (1/sqrt(head_dim)); schedule as above (packed-pair takes an
// even head count). Returns a cudaError_t (0 = launched).
int bvt_attention(const void* q, const void* k, const void* v, void* o,
                  int B, int seq, int heads, int head_dim, int dtype,
                  float scale, int schedule, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_schedule<float>(q, k, v, o, B, seq, heads, head_dim, scale,
                                  schedule, s);
  if (dtype == 1)
    return launch_schedule<__nv_bfloat16>(q, k, v, o, B, seq, heads, head_dim, scale,
                                          schedule, s);
  return cudaErrorInvalidValue;
}

const char* bvt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
