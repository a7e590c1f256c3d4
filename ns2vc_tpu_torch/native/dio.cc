// The port's copy of ns2vc_tpu/native/dio.cc: the port imports nothing of the JAX package.
// Native DIO + StoneMask F0 estimator.
//
// C++ implementation of the same algorithm as ns2vc_tpu_torch/audio/f0.py (the
// WORLD DIO/StoneMask estimators, Morise et al., IEICE 2016) for the
// preprocess host hot loop — the role pyworld's C++ plays for the
// reference (utils.py:182-195). Exposed through a plain C ABI consumed
// via ctypes (ns2vc_tpu_torch/native/__init__.py).
//
// Build: g++ -O3 -shared -fPIC -o libns2vc_dsp.so dio.cc

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using cplx = std::complex<double>;
constexpr double kPi = 3.14159265358979323846;
constexpr double kTiny = 1e-12;
constexpr double kBadScore = 1e5;

// ---------------------------------------------------------------------------
// radix-2 FFT (iterative, in-place)
// ---------------------------------------------------------------------------

void fft_inplace(std::vector<cplx>& a, bool inverse) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = 2 * kPi / double(len) * (inverse ? 1.0 : -1.0);
    const cplx wlen(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      cplx w(1.0, 0.0);
      for (size_t k = 0; k < len / 2; ++k) {
        cplx u = a[i + k];
        cplx v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (inverse) {
    for (auto& x : a) x /= double(n);
  }
}

size_t next_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

std::vector<double> nuttall(int n) {
  std::vector<double> w(n);
  for (int i = 0; i < n; ++i) {
    double t = double(i) / (n - 1.0);
    w[i] = 0.355768 - 0.487396 * std::cos(2 * kPi * t) +
           0.144232 * std::cos(4 * kPi * t) - 0.012604 * std::cos(6 * kPi * t);
  }
  return w;
}

// ---------------------------------------------------------------------------
// zero-crossing interval candidates
// ---------------------------------------------------------------------------

struct Intervals {
  std::vector<double> f0;        // interval frequencies
  std::vector<double> location;  // midpoint times (s)
};

Intervals zero_crossings(const std::vector<double>& y, double fs) {
  Intervals out;
  std::vector<double> fine;
  for (size_t i = 0; i + 1 < y.size(); ++i) {
    if (y[i] > 0.0 && y[i + 1] <= 0.0) {
      fine.push_back(double(i) + y[i] / (y[i] - y[i + 1]));
    }
  }
  if (fine.size() < 2) return out;
  out.f0.resize(fine.size() - 1);
  out.location.resize(fine.size() - 1);
  for (size_t i = 0; i + 1 < fine.size(); ++i) {
    out.f0[i] = fs / (fine[i + 1] - fine[i]);
    out.location[i] = (fine[i] + fine[i + 1]) / 2.0 / fs;
  }
  return out;
}

double interp1(const std::vector<double>& xs, const std::vector<double>& ys,
               double xi) {
  // linear interpolation with linear extrapolation at the edges
  size_t lo = 0, hi = xs.size() - 1;
  if (xi <= xs.front()) {
    lo = 0;
  } else if (xi >= xs.back()) {
    lo = xs.size() - 2;
  } else {
    while (hi - lo > 1) {
      size_t mid = (lo + hi) / 2;
      if (xs[mid] <= xi) lo = mid; else hi = mid;
    }
  }
  const double x0 = xs[lo], x1 = xs[lo + 1];
  const double w = (xi - x0) / std::max(x1 - x0, kTiny);
  return ys[lo] + w * (ys[lo + 1] - ys[lo]);
}

void band_candidate(const std::vector<double>& filtered, double fs,
                    double boundary_f0, double f0_floor, double f0_ceil,
                    const std::vector<double>& positions,
                    std::vector<double>* cand, std::vector<double>* score) {
  const size_t nf = positions.size();
  cand->assign(nf, 0.0);
  score->assign(nf, kBadScore);

  std::vector<double> dy(filtered.size() - 1);
  for (size_t i = 0; i + 1 < filtered.size(); ++i)
    dy[i] = filtered[i + 1] - filtered[i];
  std::vector<double> neg_y(filtered.size()), neg_dy(dy.size());
  for (size_t i = 0; i < filtered.size(); ++i) neg_y[i] = -filtered[i];
  for (size_t i = 0; i < dy.size(); ++i) neg_dy[i] = -dy[i];

  Intervals ev[4] = {zero_crossings(filtered, fs), zero_crossings(neg_y, fs),
                     zero_crossings(dy, fs), zero_crossings(neg_dy, fs)};
  for (int e = 0; e < 4; ++e)
    if (ev[e].f0.size() < 2) return;

  for (size_t f = 0; f < nf; ++f) {
    double vals[4];
    double mean = 0.0;
    for (int e = 0; e < 4; ++e) {
      vals[e] = interp1(ev[e].location, ev[e].f0, positions[f]);
      mean += vals[e];
    }
    mean /= 4.0;
    double dev = 0.0;
    for (int e = 0; e < 4; ++e) dev += (vals[e] - mean) * (vals[e] - mean);
    dev = std::sqrt(dev / 3.0);
    if (mean > boundary_f0 || mean < boundary_f0 / 2.0 || mean > f0_ceil ||
        mean < f0_floor) {
      continue;
    }
    (*cand)[f] = mean;
    (*score)[f] = dev;
  }
}

// ---------------------------------------------------------------------------
// contour fixing
// ---------------------------------------------------------------------------

void fix_step1(const std::vector<double>& f0, int vrm, double allowed_range,
               std::vector<double>* out) {
  const size_t n = f0.size();
  out->assign(n, 0.0);
  for (size_t i = size_t(vrm); i < n; ++i) {
    const double prev = f0[i - 1];
    if (std::fabs((f0[i] - prev) / (f0[i] + kTiny)) < allowed_range)
      (*out)[i] = f0[i];
  }
}

void fix_step2(const std::vector<double>& f0, int vrm,
               std::vector<double>* out) {
  const int n = int(f0.size());
  const int center = (vrm - 1) / 2;
  *out = f0;
  for (int i = 0; i < n; ++i) {
    bool ok = i >= center && i < n - center;
    if (ok) {
      for (int j = i - center; j <= i + center; ++j)
        if (f0[j] <= 0.0) { ok = false; break; }
    }
    if (!ok) (*out)[i] = 0.0;
  }
}

void extend(std::vector<double>* f0v,
            const std::vector<std::vector<double>>& cands,
            double allowed_range, bool forward) {
  std::vector<double>& f0 = *f0v;
  const int n = int(f0.size());
  const int nb = int(cands.size());

  // collect voiced sections
  std::vector<std::pair<int, int>> sections;  // [start, end)
  int start = -1;
  for (int i = 0; i <= n; ++i) {
    const bool v = i < n && f0[i] > 0.0;
    if (v && start < 0) start = i;
    if (!v && start >= 0) { sections.push_back({start, i}); start = -1; }
  }
  if (!forward) {
    std::vector<std::pair<int, int>> rev(sections.rbegin(), sections.rend());
    sections.swap(rev);
  }

  for (auto [s, e] : sections) {
    if (e - s < 2) continue;
    int edge = forward ? e - 1 : s;
    const int step = forward ? 1 : -1;
    const int limit = forward ? n : -1;
    double cur = f0[edge];
    double slope = f0[edge] - f0[edge - step];
    for (int i = edge + step; i != limit && f0[i] == 0.0; i += step) {
      const double ref = cur + slope;
      double best_err = 1e30, best_val = 0.0;
      for (int b = 0; b < nb; ++b) {
        const double c = cands[b][i];
        const double err = std::fabs(c - ref) / (ref + kTiny);
        if (c > 0.0 && err < best_err) { best_err = err; best_val = c; }
      }
      if (best_val <= 0.0 || best_err >= allowed_range) break;
      f0[i] = best_val;
      slope = best_val - cur;
      cur = best_val;
    }
  }
}

// ---------------------------------------------------------------------------
// StoneMask refinement
// ---------------------------------------------------------------------------

double refine_once(const double* x, int n, int fs, double position,
                   double f0_initial, double f0_floor, double f0_ceil) {
  if (f0_initial <= 0.0) return 0.0;
  const int half = int(1.5 * fs / f0_initial + 1.0);
  const int wlen = 2 * half + 1;
  const double window_time = double(wlen) / fs;
  const size_t fft_size = next_pow2(size_t(wlen)) * 2;

  std::vector<double> main_w(wlen), diff_w(wlen), seg(wlen);
  for (int i = 0; i < wlen; ++i) {
    const double bt = double(i - half) / fs;
    const int64_t idx_raw =
        int64_t(std::lround((position + bt) * fs + 0.001));
    const double wt = double(idx_raw) / fs - position;
    main_w[i] = 0.42 + 0.5 * std::cos(2 * kPi * wt / window_time) +
                0.08 * std::cos(4 * kPi * wt / window_time);
    const int64_t idx = std::min<int64_t>(std::max<int64_t>(idx_raw, 0), n - 1);
    seg[i] = x[idx];
  }
  for (int i = 1; i + 1 < wlen; ++i)
    diff_w[i] = -(main_w[i + 1] - main_w[i - 1]) / 2.0;
  diff_w[0] = -main_w[1] / 2.0;
  diff_w[wlen - 1] = main_w[wlen - 2] / 2.0;

  std::vector<cplx> spec(fft_size, cplx(0, 0)), dspec(fft_size, cplx(0, 0));
  for (int i = 0; i < wlen; ++i) {
    spec[i] = cplx(seg[i] * main_w[i], 0);
    dspec[i] = cplx(seg[i] * diff_w[i], 0);
  }
  fft_inplace(spec, false);
  fft_inplace(dspec, false);

  const int half_bins = int(fft_size / 2) + 1;
  const int n_harm = std::min(int(fs / 2.0 / f0_initial), 6);
  if (n_harm < 1) return 0.0;
  double num = 0.0, den = 0.0;
  for (int k = 1; k <= n_harm; ++k) {
    int bin = int(std::lround(f0_initial * k * double(fft_size) / fs));
    bin = std::min(bin, half_bins - 1);
    const double re = spec[bin].real(), im = spec[bin].imag();
    const double power = std::max(re * re + im * im, kTiny);
    const double numerator = re * dspec[bin].imag() - im * dspec[bin].real();
    const double freq = double(bin) * fs / double(fft_size) +
                        numerator / power * fs / (2 * kPi);
    const double amp = std::sqrt(power);
    num += amp * freq;
    den += amp * k;
  }
  const double refined = num / std::max(den, kTiny);
  if (refined < f0_floor || refined > f0_ceil) return 0.0;
  return refined;
}

}  // namespace

extern "C" {

// f0_out must hold n_frames = int(n / fs * 1000 / frame_period) + 1 values.
int ns2vc_dio(const double* x_in, int n, int fs, double f0_floor,
              double f0_ceil, double channels_in_octave, double frame_period,
              double allowed_range, double* f0_out, int n_frames_out) {
  if (n <= 0 || n_frames_out <= 0) return -1;
  std::vector<double> x(x_in, x_in + n);
  const int n_frames = int(double(n) / fs * 1000.0 / frame_period) + 1;
  if (n_frames_out < n_frames) return -2;

  std::vector<double> positions(n_frames);
  for (int i = 0; i < n_frames; ++i) positions[i] = i * frame_period / 1000.0;

  // low-cut (50 Hz high-pass) folded into the spectrum: y_spec = X * LCF.
  // The linear-phase delay is compensated together with each band filter's
  // group delay when reading the filtered signal.
  const int lcf_len = int(std::lround(double(fs) / 50.0)) * 2 + 1;
  const int lcf_delay = (lcf_len - 1) / 2;
  const size_t max_band_taps = size_t(std::lround(fs / f0_floor * 4)) + 1;
  const size_t fft_size = next_pow2(x.size() + lcf_len + max_band_taps);

  std::vector<cplx> y_spec(fft_size, cplx(0, 0));
  for (size_t i = 0; i < x.size(); ++i) y_spec[i] = cplx(x[i], 0);
  fft_inplace(y_spec, false);
  {
    std::vector<double> lcf(lcf_len, 0.0);
    double sum = 0.0;
    for (int i = 1; i <= lcf_len; ++i) {
      lcf[i - 1] = 0.5 - 0.5 * std::cos(double(i) * 2 * kPi / (lcf_len + 1));
      sum += lcf[i - 1];
    }
    for (auto& v : lcf) v = -v / sum;
    lcf[lcf_delay] += 1.0;
    std::vector<cplx> lcf_spec(fft_size, cplx(0, 0));
    for (int i = 0; i < lcf_len; ++i) lcf_spec[i] = cplx(lcf[i], 0);
    fft_inplace(lcf_spec, false);
    for (size_t i = 0; i < fft_size; ++i) y_spec[i] *= lcf_spec[i];
  }

  const int n_bands =
      1 + int(std::log2(f0_ceil / f0_floor) * channels_in_octave);
  std::vector<std::vector<double>> cands(n_bands), scores(n_bands);

  // two real band filters per complex inverse FFT: with real y and real
  // filters h1, h2, ifft(Y*(H1 + i*H2)) = filt1 + i*filt2 exactly.
  auto run_pair = [&](int b1, int b2) {
    std::vector<cplx> k(fft_size, cplx(0, 0));
    const double bf0_1 =
        f0_floor * std::pow(2.0, double(b1 + 1) / channels_in_octave);
    const int half1 = int(std::lround(fs / bf0_1 / 2.0));
    std::vector<double> lpf1 = nuttall(4 * half1);
    for (size_t i = 0; i < lpf1.size(); ++i) k[i] += cplx(lpf1[i], 0.0);
    int half2 = 0;
    double bf0_2 = 0.0;
    if (b2 >= 0) {
      bf0_2 = f0_floor * std::pow(2.0, double(b2 + 1) / channels_in_octave);
      half2 = int(std::lround(fs / bf0_2 / 2.0));
      std::vector<double> lpf2 = nuttall(4 * half2);
      for (size_t i = 0; i < lpf2.size(); ++i) k[i] += cplx(0.0, lpf2[i]);
    }
    fft_inplace(k, false);
    for (size_t i = 0; i < fft_size; ++i) k[i] *= y_spec[i];
    fft_inplace(k, true);

    std::vector<double> filtered(x.size());
    const size_t bias1 = size_t(lcf_delay) + size_t(half1) * 2;
    for (size_t i = 0; i < x.size(); ++i)
      filtered[i] = (i + bias1 < fft_size) ? k[i + bias1].real() : 0.0;
    band_candidate(filtered, fs, bf0_1, f0_floor, f0_ceil, positions,
                   &cands[b1], &scores[b1]);
    if (b2 >= 0) {
      const size_t bias2 = size_t(lcf_delay) + size_t(half2) * 2;
      for (size_t i = 0; i < x.size(); ++i)
        filtered[i] = (i + bias2 < fft_size) ? k[i + bias2].imag() : 0.0;
      band_candidate(filtered, fs, bf0_2, f0_floor, f0_ceil, positions,
                     &cands[b2], &scores[b2]);
    }
  };
  {
    std::vector<std::thread> threads;
    for (int b = 0; b < n_bands; b += 2) {
      const int b2 = (b + 1 < n_bands) ? b + 1 : -1;
      threads.emplace_back(run_pair, b, b2);
    }
    for (auto& t : threads) t.join();
  }

  std::vector<double> best(n_frames, 0.0);
  for (int f = 0; f < n_frames; ++f) {
    double best_score = 1e30;
    for (int b = 0; b < n_bands; ++b) {
      const double s = scores[b][f] / (cands[b][f] + kTiny);
      if (s < best_score) { best_score = s; best[f] = cands[b][f]; }
    }
  }

  const int vrm = int(0.5 + 1000.0 / frame_period / f0_floor) * 2 + 1;
  std::vector<double> f0 = best;
  if (n_frames > vrm) {
    std::vector<double> tmp;
    fix_step1(best, vrm, allowed_range, &tmp);
    fix_step2(tmp, vrm, &f0);
    extend(&f0, cands, allowed_range, true);
    extend(&f0, cands, allowed_range, false);
  }
  std::memcpy(f0_out, f0.data(), sizeof(double) * n_frames);
  for (int i = n_frames; i < n_frames_out; ++i) f0_out[i] = 0.0;
  return n_frames;
}

int ns2vc_stonemask(const double* x, int n, int fs, const double* f0_in,
                    const double* positions, int n_frames, double f0_floor,
                    double f0_ceil, double* f0_out) {
  for (int i = 0; i < n_frames; ++i) {
    const double f = f0_in[i];
    if (f <= 0.0) { f0_out[i] = 0.0; continue; }
    const double r1 = refine_once(x, n, fs, positions[i], f, f0_floor, f0_ceil);
    const double r2 = refine_once(x, n, fs, positions[i], r1, f0_floor, f0_ceil);
    if (r2 > 0.0 && std::fabs(r2 - f) / f < 0.2) {
      f0_out[i] = r2;
    } else if (r1 > 0.0 && std::fabs(r1 - f) / f < 0.2) {
      f0_out[i] = r1;
    } else {
      f0_out[i] = f;
    }
  }
  return n_frames;
}

}  // extern "C"
