// The 16-bit operand types shared by the kernels that take float32,
// bfloat16 and float16 operands through one template (graph_layer,
// natr_attention, deepapf_attention, conet_tower): a value of the operands'
// type T is widened exactly to float32 as it is loaded, sums run in float32,
// and rnd<T> rounds a float32 to nearest in T where the 16-bit form stores
// or names a 16-bit value; for T = float every helper is the plain float32
// access and rnd the identity. ops/build.py hashes this header into every
// library's name, so an edit here rebuilds them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

template <typename T>
constexpr bool kWide = std::is_same_v<T, float>;

// a 16-bit value's bits widened to float32, and float32 rounded to nearest
// in T as bits
template <typename T>
__device__ __forceinline__ float from_bits(unsigned b);
template <>
__device__ __forceinline__ float from_bits<__nv_bfloat16>(unsigned b) {
  return __uint_as_float(b << 16);
}
template <>
__device__ __forceinline__ float from_bits<__half>(unsigned b) {
  return __half2float(__ushort_as_half((unsigned short)b));
}
template <typename T>
__device__ __forceinline__ unsigned to_bits(float x);
template <>
__device__ __forceinline__ unsigned to_bits<__nv_bfloat16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ unsigned to_bits<__half>(float x) {
  return __half_as_ushort(__float2half_rn(x));
}

// x rounded to nearest in T, as a float32 (the identity for float32)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kWide<T>) return x;
  else return from_bits<T>(to_bits<T>(x));
}

// one value of T widened, four consecutive ones widened (16-byte aligned for
// float32, 8-byte for 16 bits), one stored (the value already rounded to T)
template <typename T>
__device__ __forceinline__ float ld1(const T* p) {
  if constexpr (kWide<T>) return __ldg(p);
  else return from_bits<T>(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
template <typename T>
__device__ __forceinline__ float4 ld4(const T* p) {
  if constexpr (kWide<T>) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(from_bits<T>(t.x & 0xFFFFu), from_bits<T>(t.x >> 16),
                       from_bits<T>(t.y & 0xFFFFu), from_bits<T>(t.y >> 16));
  }
}
template <typename T>
__device__ __forceinline__ void st1(T* p, float v) {
  if constexpr (kWide<T>) *p = v;
  else *reinterpret_cast<unsigned short*>(p) = (unsigned short)to_bits<T>(v);
}

}  // namespace
