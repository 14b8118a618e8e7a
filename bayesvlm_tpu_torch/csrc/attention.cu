// Fused non-causal multi-head self-attention for the vision towers, in
// three schedules of one function: one-block (`_mha_kernel`), split-key
// (`_mha_split_kernel`) and packed-pair (`_mha_packed_kernel`) of
// bayesvlm_tpu/models/attention_pallas.py.
//
// Two bodies compute it. bf16 runs all three schedules with both
// products on the tensor cores (mma.sync m16n8k16, K and V staged by
// cp.async, two sweeps over the keys for an exact softmax without a score
// tile; the packed pair as one block of two heads side by side):
// csrc/attention_mma.cuh, which says what bounds it and how the design
// meets it. fp32 inputs keep the CUDA-core body with the whole score tile
// in shared memory (the tensor cores would round them to TF32):
// csrc/attention.cuh. The rounding points, which both keep, are in
// attention.cuh.
//
// Built by bayesvlm_tpu_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the bottom (ctypes).

#include "attention_mma.cuh"

namespace {

using namespace bvt_attn;

// f(schedule as a std::integral_constant), or fallback for no such schedule
template <typename R, typename F>
R by_schedule(int schedule, R fallback, F f) {
  switch (schedule) {
    case kOneBlock: return f(std::integral_constant<int, kOneBlock>());
    case kSplitKey: return f(std::integral_constant<int, kSplitKey>());
    case kPackedPair: return f(std::integral_constant<int, kPackedPair>());
    default: return fallback;
  }
}

template <typename T>
int launch_schedule(const void* q, const void* k, const void* v, void* o, int B,
                    int seq, int heads, int head_dim, float scale, int schedule,
                    cudaStream_t stream) {
  return by_schedule(schedule, (int)cudaErrorInvalidValue, [&](auto s) {
    return (int)launch_head_dim<T, decltype(s)::value>(q, k, v, o, B, seq, heads,
                                                       head_dim, scale, stream);
  });
}

template <typename T>
long smem_bytes(int schedule, int head_dim, int seq) {
  return by_schedule(schedule, 0L, [&](auto s) {
    return plan<T, decltype(s)::value>(head_dim, seq).bytes;
  });
}

template <typename T>
int mma_body(int schedule) {
  return by_schedule(schedule, -1, [](auto) { return (int)uses_mma<T>(); });
}

template <typename T>
int occupancy_of(int schedule, int head_dim, int seq, int* regs, int* blocks) {
  return by_schedule(schedule, (int)cudaErrorInvalidValue, [&](auto s) {
    return (int)occupancy<T, decltype(s)::value>(head_dim, seq, regs, blocks);
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; schedule: 0 one-block, 1 split-key,
// 2 packed-pair (an even head count)

// bytes of dynamic shared memory one block of the body that (dtype,
// schedule) launches needs for seq keys (0: no such head dim)
long bvt_attention_smem_bytes(int seq, int head_dim, int dtype, int schedule) {
  return dtype == 1 ? smem_bytes<__nv_bfloat16>(schedule, head_dim, seq)
                    : smem_bytes<float>(schedule, head_dim, seq);
}

// 1 when (dtype, schedule) launches the tensor-core body, 0 the CUDA-core
// one, -1 for no such schedule
int bvt_attention_uses_mma(int dtype, int schedule) {
  return dtype == 1 ? mma_body<__nv_bfloat16>(schedule) : mma_body<float>(schedule);
}

// registers a thread and blocks an SM (the occupancy calculator) of the
// kernel that (dtype, schedule, head_dim, seq) launches. Returns a
// cudaError_t (0 = both written).
int bvt_attention_occupancy(int seq, int head_dim, int dtype, int schedule, int* regs,
                            int* blocks_per_sm) {
  return dtype == 1
             ? occupancy_of<__nv_bfloat16>(schedule, head_dim, seq, regs, blocks_per_sm)
             : occupancy_of<float>(schedule, head_dim, seq, regs, blocks_per_sm);
}

// the most dynamic shared memory a block of the current device may opt
// in to, or -1 when the device cannot be queried
int bvt_attention_smem_limit(void) {
  const int optin = bvt_attn::smem_optin();
  return optin < 0 ? -1 : optin;
}

// scale multiplies the fp32 dot products (1/sqrt(head_dim)); q, k, v, o
// 16-byte aligned for the tensor-core body. Returns a cudaError_t (0 =
// launched).
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
