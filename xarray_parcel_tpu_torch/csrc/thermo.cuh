// Point thermodynamics shared by the kernels (fused_cape.cu, prepass.cu,
// diag_tail.cu, mix_layer.cu, most_unstable.cu):
// constants.py's values and thermo.py's functions, op for op as the plain
// twins' torch ops (tests/test_torch_adiabat.py holds the constants).

#pragma once

#include "column.cuh"

namespace {

constexpr double kRd = 287.04749097718457;
constexpr double kCpd = 1004.6662184201459;
constexpr double kLv = 2.50084e6;
constexpr double kKappa = 0.28571428571428575;
constexpr double kEpsilon = 0.6219569100577033;
constexpr double kSatPressure0c = 6.112;
constexpr double kZeroC = 273.15;
constexpr double kVirtualEps = 0.608;
constexpr double kP0 = 1000.0;  // hPa, of theta and the Exner function

constexpr int kScalars = 6;  // fused.SCALARS: lcl_p, lcl_t, lcl_vt, w0, t0, p0

template <typename T>
__device__ __forceinline__ T saturation_vapor_pressure(T t) {
  return T(kSatPressure0c) *
         dexp(T(17.67) * (t - T(kZeroC)) / (t - T(29.65)));
}

// Saturation mixing ratio at (p, T).
template <typename T>
__device__ __forceinline__ T saturation_mixing_ratio(T p, T t) {
  const T e = saturation_vapor_pressure(t);
  return T(kEpsilon) * e / (p - e);
}

// RH-route mixing ratio, algebraically fused.
template <typename T>
__device__ __forceinline__ T mixing_ratio(T t, T td, T p) {
  return T(kEpsilon) * saturation_vapor_pressure(td) /
         (p - saturation_vapor_pressure(t));
}

template <typename T>
__device__ __forceinline__ T virtual_temperature(T t, T w) {
  return t * (T(1) + T(kVirtualEps) * w);
}

// x / c for a constant c, as the card's torch divides by a Python number.
template <typename T> __device__ __forceinline__ T div_c(T x, double c) {
  return x * (T(1) / T(c));
}

// c / x for a constant c, as the card's torch divides a Python number by a
// tensor: the tensor's reciprocal times the number (Tensor.__rtruediv__).
template <typename T> __device__ __forceinline__ T rdiv_c(double c, T x) {
  return (T(1) / x) * T(c);
}

// Dewpoint from the vapour pressure e.
template <typename T> __device__ __forceinline__ T dewpoint(T e) {
  const T val = dlog(div_c(e, kSatPressure0c));
  return T(kZeroC) + T(243.5) * val / (T(17.67) - val);
}

// Vapour pressure at p of mixing ratio w.
template <typename T> __device__ __forceinline__ T vapor_pressure(T p, T w) {
  return p * w / (w + T(kEpsilon));
}

template <typename T> __device__ __forceinline__ T exner_function(T p) {
  return dpow(div_c(p, kP0), T(kKappa));
}

template <typename T>
__device__ __forceinline__ T potential_temperature(T p, T t) {
  return t / exner_function(p);
}

// Bolton (1980) theta-e, op for op as thermo.equivalent_potential_temperature
// runs on the card: a power by a Python number raises to it in the working
// type (torch's tensor-scalar pow), a power by a tensor raises elementwise
// (tensor-tensor pow); both are pow() of the working type.
template <typename T>
__device__ __forceinline__ T equivalent_potential_temperature(T p, T t,
                                                              T td) {
  const T e = saturation_vapor_pressure(td);
  const T r = T(kEpsilon) * e / (p - e);
  const T t_l =
      rdiv_c(1.0, rdiv_c(1.0, td - T(56)) + div_c(dlog(t / td), 800.0)) +
      T(56);
  const T th_l = t * dpow(rdiv_c(kP0, p - e), T(kKappa)) *
                 dpow(t / t_l, T(0.28) * r);
  return th_l *
         dexp(r * (T(0.448) * r + T(1)) * (rdiv_c(3036.0, t_l) - T(1.78)));
}

}  // namespace
