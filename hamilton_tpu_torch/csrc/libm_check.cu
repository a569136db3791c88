// A check of chain_forms.cuh's float sin/cos and libm_fast.cuh's sqrt and
// reciprocal (the chain kernels' trig aux and factors, the batched factor
// and solve of batched_spd.cu) against the functions the plain version's
// kernel called before them, sinf, cosf, sqrtf and 1/x, on the card: every
// float bit pattern in each one's range, compared bit for bit.
// Checked are the straight-line versions (sincos_fast, sqrt_fast,
// rcp_fast) and the library's functions that take over where an input is
// outside their range (sincosf for the aux, __frcp_rn for the factor).
// Not a kernel of the step: chip_smoke.py (phase 1) and the card-only tests
// run it, because the straight-line versions restate the library's
// expansions as nvcc compiles them, and another toolkit could change those.
//
// Build: as fused_step.cu.

#include "chain_forms.cuh"

namespace {

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);  // NaNs alike
}

constexpr int kChecks = 5;

// Counts into mismatches[0..kChecks) the floats x (a grid-strided pass over
// all 2^32 bit patterns) whose value differs from the reference's:
// sincos_fast (either value) from sinf and cosf where in its range; the
// library's sincosf from them on every float; sqrt_fast from sqrtf and
// rcp_fast from 1/x where in their ranges; __frcp_rn from 1/x on every
// float.
__global__ void libm_check_kernel(unsigned long long* mismatches) {
  unsigned long long bad[kChecks] = {0, 0, 0, 0, 0};
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long u =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       u < (1ull << 32); u += stride) {
    const float x = __uint_as_float(static_cast<unsigned int>(u));
    const float s = sinf(x), c = cosf(x), r = 1.0f / x;
    float s1, c1;
    if (sincos_fast_range(x)) {
      sincos_fast(x, &s1, &c1);
      bad[0] += same_bits(s, s1) && same_bits(c, c1) ? 0 : 1;
    }
    sincosf(x, &s1, &c1);
    bad[1] += same_bits(s, s1) && same_bits(c, c1) ? 0 : 1;
    if (sqrt_fast_range(x)) bad[2] += same_bits(sqrtf(x), sqrt_fast(x)) ? 0 : 1;
    if (rcp_fast_range(x)) bad[3] += same_bits(r, rcp_fast(x)) ? 0 : 1;
    bad[4] += same_bits(r, __frcp_rn(x)) ? 0 : 1;
  }
  for (int k = 0; k < kChecks; ++k)
    if (bad[k]) atomicAdd(&mismatches[k], bad[k]);
}

}  // namespace

extern "C" {

// The floats whose value differs from the reference's, each check of
// libm_check_kernel in its order, all 2^32 bit patterns tried, into
// mismatches[0..5) (host memory); synchronizes.  Returns 0 or a
// CUDA error's code.
int hamilton_libm_check(unsigned long long* mismatches) {
  unsigned long long* dev = nullptr;
  cudaError_t err = cudaMalloc(&dev, kChecks * sizeof(unsigned long long));
  if (err == cudaSuccess) err = cudaMemset(dev, 0, kChecks * sizeof(unsigned long long));
  if (err == cudaSuccess) {
    libm_check_kernel<<<132 * 16, 256>>>(dev);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = cudaMemcpy(mismatches, dev, kChecks * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  cudaFree(dev);
  return static_cast<int>(err);
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
