// Speed-of-light probes for NVIDIA Hopper (sm_90a): the card's float32 FMA
// rate, the rate of the float32 sine the step kernels run and its
// device-memory bandwidth.
//
// Replace the TPU probes of hamilton_tpu/utils/roofline.py:
//   K3a hamilton_fma_probe  <- _vpu_probe_fn (pl.pallas_call at :277),
//   K3b hamilton_sin_probe  <- _trig_probe_fn (pl.pallas_call at :322),
//   K3c hamilton_add_one    <- the kernel of hbm_peak_probe (pl.pallas_call at :392).
// The plain PyTorch versions and the timing are in
// hamilton_tpu_torch/utils/roofline.py.
//
// K3a and K3b are bound by operations, K3c by bytes: each is built to reach
// that bound and nothing else.
//   - K3a: each thread carries CHAINS independent chains x <- fma(x, a, c) in
//     registers, so every SM scheduler has CHAINS independent FMAs in flight
//     per warp to cover the FMA latency.  reps is a run-time argument and
//     every chain is stored at the end, so nvcc can neither fold nor drop
//     the loop.  Element k of thread t is x[k * threads + t]: loads and
//     stores coalesce.
//   - K3b: the same loop with x <- sinf(x) + c, its sine libm_fast.cuh's
//     sin_fast: the straight-line reduction and polynomial of sinf's fast
//     path, the sine the step kernels run since they dropped the library's
//     branching sinf/cosf (sincos_fast, its pair), not the SFU's
//     approximate __sinf.  A rep takes every chain's sin_fast, then one
//     branch: where a chain left sincos_fast_range, the library's sinf for
//     it.  So the kernel computes sinf for every input, and a thread's
//     chains interleave.  Its bound is the work a sine equal to sinf needs
//     on its slowest pipe: 12 float32 FMAs, multiplies and adds at 128 a
//     clock an SM, and 2 conversions (F2I, I2FP) at 16, which bound it
//     (utils/roofline.py's SIN_WORK; scripts/k3b_sass.py checks both counts
//     in this loop's SASS).
//   - K3c: out = a + 1, grid-strided with 16-byte (float4) loads and stores
//     over an array far larger than the 50 MB L2, so every byte comes from
//     and goes to device memory once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//             -Xcompiler -fPIC -o libroofline_probes.so roofline_probes.cu

#include "libm_fast.cuh"

namespace {

constexpr float kMul = 1.0000001f;
constexpr float kAdd = 1.1920929e-07f;

template <int CHAINS>
__global__ void fma_probe_kernel(const float* __restrict__ x_in, float* __restrict__ x_out,
                                 long long threads, int reps) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  float x[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) x[k] = x_in[k * threads + t];
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) x[k] = fmaf(x[k], kMul, kAdd);
  }
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) x_out[k * threads + t] = x[k];
}

template <int CHAINS>
__global__ void sin_probe_kernel(const float* __restrict__ x_in, float* __restrict__ x_out,
                                 long long threads, int reps) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  float x[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) x[k] = x_in[k * threads + t];
  for (int r = 0; r < reps; ++r) {
    float y[CHAINS];
    bool fast = true;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
      fast = fast && sincos_fast_range(x[k]);
      y[k] = sin_fast(x[k]);
    }
    if (!fast) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k)
        if (!sincos_fast_range(x[k])) y[k] = sinf(x[k]);
    }
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) x[k] = y[k] + kAdd;
  }
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) x_out[k * threads + t] = x[k];
}

__global__ void add_one_kernel(const float4* __restrict__ a, float4* __restrict__ out,
                               long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 v = a[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    out[i] = v;
  }
}

template <int CHAINS, bool SIN>
int launch_chain(const void* x_in, void* x_out, long long threads, int reps, int block,
                 cudaStream_t stream) {
  const long long blocks = (threads + block - 1) / block;
  if constexpr (SIN)
    sin_probe_kernel<CHAINS><<<static_cast<unsigned int>(blocks), block, 0, stream>>>(
        static_cast<const float*>(x_in), static_cast<float*>(x_out), threads, reps);
  else
    fma_probe_kernel<CHAINS><<<static_cast<unsigned int>(blocks), block, 0, stream>>>(
        static_cast<const float*>(x_in), static_cast<float*>(x_out), threads, reps);
  return static_cast<int>(cudaGetLastError());
}

// chains in {1, 2, 4, 8, 16, 32}; elements a multiple of chains.
template <bool SIN>
int dispatch_chain(int chains, const void* x_in, void* x_out, long long elements, int reps,
                   int block, void* stream) {
  if (elements < 1 || reps < 0 || block < 32 || block > 1024 || block % 32 != 0 ||
      chains < 1 || elements % chains != 0)
    return -2;
  const long long threads = elements / chains;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: return launch_chain<1, SIN>(x_in, x_out, threads, reps, block, st);
    case 2: return launch_chain<2, SIN>(x_in, x_out, threads, reps, block, st);
    case 4: return launch_chain<4, SIN>(x_in, x_out, threads, reps, block, st);
    case 8: return launch_chain<8, SIN>(x_in, x_out, threads, reps, block, st);
    case 16: return launch_chain<16, SIN>(x_in, x_out, threads, reps, block, st);
    case 32: return launch_chain<32, SIN>(x_in, x_out, threads, reps, block, st);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// K3a: reps dependent fma(x, 1.0000001f, 1.1920929e-07f) on each of the
// `elements` floats of x_in into x_out, `chains` elements per thread.
// Returns 0, -1 for an uninstantiated chain count, -2 for a bad argument,
// or cudaGetLastError()'s code.
int hamilton_fma_probe(int chains, const void* x_in, void* x_out, long long elements,
                       int reps, int block, void* stream) {
  return dispatch_chain<false>(chains, x_in, x_out, elements, reps, block, stream);
}

// K3b: reps dependent sinf(x) + 1.1920929e-07f (its sine sin_fast where x
// is in sincos_fast_range, else sinf), laid out as K3a.
int hamilton_sin_probe(int chains, const void* x_in, void* x_out, long long elements,
                       int reps, int block, void* stream) {
  return dispatch_chain<true>(chains, x_in, x_out, elements, reps, block, stream);
}

// K3c: out = a + 1 over `elements` floats (a multiple of 4, both pointers
// 16-byte aligned), on `blocks` blocks of 256 threads striding the array.
int hamilton_add_one(const void* a, void* out, long long elements, int blocks,
                     void* stream) {
  if (elements < 4 || elements % 4 != 0 || blocks < 1) return -2;
  add_one_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<float4*>(out), elements / 4);
  return static_cast<int>(cudaGetLastError());
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
