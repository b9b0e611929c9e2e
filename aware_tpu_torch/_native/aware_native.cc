// aware_tpu_torch host runtime: WAV I/O, VAD, PCM quantization, batch loader.
//
// The port's own copy of the JAX package's native runtime
// (aware_tpu/_native/aware_native.cc), with the batch loader's close of a
// batch fixed (below).  Host code, not a device kernel: the reference
// reaches this work through Python C extensions (libsndfile via
// soundfile, the webrtcvad extension), and ingest runs it on the host:
//
//   * RIFF/WAVE reader + writer (PCM 16/24/32 and float32)
//   * the silence-gate VAD with semantics identical to
//     aware_tpu/ops/vad.py (energy + speech-band share via an exact
//     N-point real DFT + zero-crossing rate, 30 ms frames)
//   * a WebRTC-architecture GMM VAD (6-band allpass filterbank, adaptive
//     two-component noise/speech GMMs per band, LLR hypothesis tests,
//     hangover) — the reference-faithful classifier, incl. webrtcvad's
//     loud-noise/tone false-positive tendency
//   * truncating PCM bit-depth quantization (attack preprocessing)
//   * a multithreaded prefetching batch loader that reads WAV files,
//     converts to float32 mono, pads/truncates to a fixed clip length
//     and hands batches to Python in file order
//
// Exposed as a flat C ABI consumed by aware_tpu_torch/native.py via
// ctypes, which builds it at first use:
//   g++ -O3 -std=c++17 -fPIC -pthread -shared
// into aware_tpu_torch/_build/ under a name that carries this file's hash.

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- WAV ----

struct AnWavInfo {
  int32_t sample_rate;
  int32_t channels;
  int64_t frames;  // samples per channel
};

// Reads a WAV file into a malloc'd float32 buffer (interleaved).
// Returns nullptr on failure.  Caller frees with an_free().
float* an_read_wav(const char* path, AnWavInfo* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || fread(&riff_size, 4, 1, f) != 1 ||
      fread(wave, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) ||
      memcmp(wave, "WAVE", 4)) {
    fclose(f);
    return nullptr;
  }
  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  std::vector<uint8_t> data;
  bool have_fmt = false, have_data = false;
  char chunk_id[4];
  uint32_t chunk_size;
  while (fread(chunk_id, 1, 4, f) == 4 && fread(&chunk_size, 4, 1, f) == 1) {
    if (!memcmp(chunk_id, "fmt ", 4)) {
      uint8_t buf[16];
      if (chunk_size < 16 || fread(buf, 1, 16, f) != 16) break;
      memcpy(&fmt_code, buf, 2);
      memcpy(&channels, buf + 2, 2);
      memcpy(&sample_rate, buf + 4, 4);
      memcpy(&bits, buf + 14, 2);
      if (chunk_size > 16) fseek(f, chunk_size - 16, SEEK_CUR);
      have_fmt = true;
    } else if (!memcmp(chunk_id, "data", 4)) {
      data.resize(chunk_size);
      if (fread(data.data(), 1, chunk_size, f) != chunk_size) break;
      have_data = true;
    } else {
      fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (!have_fmt || !have_data || channels == 0) return nullptr;

  int64_t n;
  float* out = nullptr;
  if (fmt_code == 3 && bits == 32) {
    n = (int64_t)(data.size() / 4);
    out = (float*)malloc(n * sizeof(float));
    memcpy(out, data.data(), n * sizeof(float));
  } else if (fmt_code == 1 && bits == 16) {
    n = (int64_t)(data.size() / 2);
    out = (float*)malloc(n * sizeof(float));
    const int16_t* p = (const int16_t*)data.data();
    for (int64_t i = 0; i < n; ++i) out[i] = p[i] / 32768.0f;
  } else if (fmt_code == 1 && bits == 24) {
    n = (int64_t)(data.size() / 3);
    out = (float*)malloc(n * sizeof(float));
    for (int64_t i = 0; i < n; ++i) {
      int32_t v = data[3 * i] | (data[3 * i + 1] << 8) |
                  (data[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      out[i] = v / 8388608.0f;
    }
  } else if (fmt_code == 1 && bits == 32) {
    n = (int64_t)(data.size() / 4);
    out = (float*)malloc(n * sizeof(float));
    const int32_t* p = (const int32_t*)data.data();
    for (int64_t i = 0; i < n; ++i) out[i] = (float)(p[i] / 2147483648.0);
  } else {
    return nullptr;
  }
  info->sample_rate = (int32_t)sample_rate;
  info->channels = (int32_t)channels;
  info->frames = n / channels;
  return out;
}

int an_write_wav(const char* path, const float* data, int64_t frames,
                 int32_t channels, int32_t sample_rate, int32_t bits) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int64_t n = frames * channels;
  uint16_t fmt_code = (bits == 32) ? 3 : 1;
  uint16_t bytes_per = (uint16_t)(bits / 8);
  uint32_t payload = (uint32_t)(n * bytes_per);
  uint32_t block = channels * bytes_per;
  uint32_t byte_rate = sample_rate * block;
  uint32_t riff_size = 36 + payload;
  uint32_t fmt_size = 16;
  uint16_t bits16 = (uint16_t)bits;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_size, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt_code, 2, 1, f);
  uint16_t ch16 = (uint16_t)channels;
  fwrite(&ch16, 2, 1, f);
  fwrite(&sample_rate, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  uint16_t block16 = (uint16_t)block;
  fwrite(&block16, 2, 1, f);
  fwrite(&bits16, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&payload, 4, 1, f);
  if (bits == 32) {
    fwrite(data, 4, n, f);
  } else if (bits == 16) {
    std::vector<int16_t> buf(n);
    for (int64_t i = 0; i < n; ++i) {
      float v = data[i];
      if (v > 1.0f) v = 1.0f;
      if (v < -1.0f) v = -1.0f;
      buf[i] = (int16_t)lrintf(v * 32767.0f);
    }
    fwrite(buf.data(), 2, n, f);
  } else {
    fclose(f);
    return -2;
  }
  fclose(f);
  return 0;
}

void an_free(void* p) { free(p); }

// ---------------------------------------------------------------- VAD ----

// Energy thresholds (dBFS) per aggressiveness, matching ops/vad.py.
static const float kEnergyDbfs[4] = {-55.0f, -50.0f, -45.0f, -40.0f};

// Exact N-point real DFT power spectrum (N is the 30 ms frame length, not
// a power of two; naive O(N^2) is fine at host ingest rates).
static void real_dft_power(const float* x, int n, std::vector<double>* pow_out) {
  int nf = n / 2 + 1;
  pow_out->assign(nf, 0.0);
  for (int k = 0; k < nf; ++k) {
    double re = 0.0, im = 0.0;
    double w = -2.0 * M_PI * k / n;
    for (int i = 0; i < n; ++i) {
      re += x[i] * cos(w * i);
      im += x[i] * sin(w * i);
    }
    (*pow_out)[k] = re * re + im * im;
  }
}

// Returns 1 when the clip is "silent" per the reference gate semantics
// (speech seconds < min_speech_seconds; reference: waveform.py:22-46).
int an_vad_is_silent(const float* audio, int64_t len, int32_t sample_rate,
                     float frame_ms, int32_t aggressiveness,
                     float min_speech_seconds) {
  int frame_len = (int)(sample_rate * frame_ms / 1000.0f);
  if (frame_len <= 0) return 1;
  int64_t n_frames = len / frame_len;
  int voiced = 0;
  int nf = frame_len / 2 + 1;
  std::vector<double> power;
  for (int64_t t = 0; t < n_frames; ++t) {
    const float* fr = audio + t * frame_len;
    // (a) energy
    double acc = 0.0;
    for (int i = 0; i < frame_len; ++i) acc += (double)fr[i] * fr[i];
    double rms = sqrt(acc / frame_len + 1e-12);
    double energy_db = 20.0 * log10(rms + 1e-12);
    if (!(energy_db > kEnergyDbfs[aggressiveness & 3])) continue;
    // (b) speech-band share, 80..3500 Hz
    real_dft_power(fr, frame_len, &power);
    double total = 0.0, band = 0.0;
    for (int k = 0; k < nf; ++k) {
      double freq = (double)k * sample_rate / frame_len;
      total += power[k];
      if (freq >= 80.0 && freq <= 3500.0) band += power[k];
    }
    if (!(band / (total + 1e-12) > 0.5)) continue;
    // (c) zero-crossing rate below 0.35
    int crossings = 0;
    for (int i = 1; i < frame_len; ++i) {
      float a = fr[i - 1] > 0 ? 1.f : (fr[i - 1] < 0 ? -1.f : 0.f);
      float b = fr[i] > 0 ? 1.f : (fr[i] < 0 ? -1.f : 0.f);
      if (fabsf(b - a) > 0) ++crossings;
    }
    if (!((double)crossings / (frame_len - 1) < 0.35)) continue;
    ++voiced;
  }
  double speech_seconds = voiced * (frame_ms / 1000.0);
  return speech_seconds < min_speech_seconds ? 1 : 0;
}

// ----------------------------------------------- GMM VAD (WebRTC-style) ---
//
// Float reimplementation of the WebRTC VAD *architecture* — the GMM
// classifier the reference's SilenceChecker calls through the webrtcvad C
// extension (reference: utils/audio/waveform.py:22-46):
//
//   * audio brought to 8 kHz by half-band allpass decimation
//   * six sub-band log-energy features (80-250, 250-500, 500-1000,
//     1000-2000, 2000-3000, 3000-4000 Hz) via WebRTC's polyphase two-path
//     allpass splits (coefficients 0.6401 and 0.1699)
//   * per band: a 2-component noise GMM and a 2-component speech GMM over
//     the log-energy feature, adapted online, with minimum-statistics
//     noise anchoring and enforced speech/noise separation
//   * per-frame decision: per-channel log-likelihood-ratio tests plus a
//     weighted global LLR, thresholds per aggressiveness (3 = strictest),
//     hangover smoothing
//
// The original's fixed-point tables are not reproduced (not available in
// this image); the float models self-adapt from role-equivalent
// initializations.  Decisions on clearly voiced / clearly unvoiced
// material match the reference gate; borderline behavior is bounded
// against the spectral gate by the JAX package's tools/vad_divergence.py.

namespace gmmvad {

struct Gauss { double mean, std; };

static inline double gauss_log_pdf(double x, const Gauss& g) {
  double d = (x - g.mean) / g.std;
  return -0.5 * d * d - log(g.std * 2.5066282746310002);
}

// one-multiplier first-order allpass: H(z) = (c + z^-1) / (1 + c z^-1)
static void allpass(const std::vector<float>& in, double c,
                    std::vector<float>* out) {
  out->resize(in.size());
  double state = 0.0;
  for (size_t i = 0; i < in.size(); ++i) {
    double y = c * in[i] + state;
    state = in[i] - c * y;
    (*out)[i] = (float)y;
  }
}

// half-band split by two-path polyphase allpass; outputs at half rate
static void split_band(const std::vector<float>& in, std::vector<float>* lp,
                       std::vector<float>* hp) {
  std::vector<float> even, odd;
  even.reserve(in.size() / 2 + 1);
  odd.reserve(in.size() / 2 + 1);
  for (size_t i = 0; i + 1 < in.size(); i += 2) {
    even.push_back(in[i]);
    odd.push_back(in[i + 1]);
  }
  if (odd.size() > even.size()) odd.resize(even.size());
  if (even.size() > odd.size()) even.resize(odd.size());
  std::vector<float> a0, a1;
  allpass(even, 0.6401, &a0);   // WebRTC kAllPassCoefsQ13 ~ 5243/8192
  allpass(odd, 0.1699, &a1);    //                         ~ 1392/8192
  lp->resize(a0.size());
  hp->resize(a0.size());
  for (size_t i = 0; i < a0.size(); ++i) {
    (*lp)[i] = 0.5f * (a0[i] + a1[i]);
    (*hp)[i] = 0.5f * (a0[i] - a1[i]);
  }
}

// Butterworth high-pass biquad, fc=80 Hz at fs=500 Hz (the lowest band's
// 80 Hz floor)
static void hp80_at500(std::vector<float>* x) {
  const double b0 = 0.4808, b1 = -0.9615, b2 = 0.4808;
  const double a1 = -0.6709, a2 = 0.2524;
  double x1 = 0, x2 = 0, y1 = 0, y2 = 0;
  for (size_t i = 0; i < x->size(); ++i) {
    double xi = (*x)[i];
    double y = b0 * xi + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
    x2 = x1; x1 = xi; y2 = y1; y1 = y;
    (*x)[i] = (float)y;
  }
}

static double log_energy(const std::vector<float>& x) {
  double acc = 0.0;
  for (float v : x) acc += (double)v * v;
  double n = x.size() > 0 ? (double)x.size() : 1.0;
  return 10.0 * log10(acc / n + 1e-12);
}

// six sub-band log energies of one 8 kHz frame
static void frame_features(const std::vector<float>& frame8k, double* feat) {
  std::vector<float> lo2k, b24, b23, b34, lo1k, b12, lo500, b051, lo250,
      b0255;
  split_band(frame8k, &lo2k, &b24);   // 0-2k | 2-4k @4k
  split_band(b24, &b23, &b34);        // 2-3k | 3-4k @2k
  split_band(lo2k, &lo1k, &b12);      // 0-1k | 1-2k @2k
  split_band(lo1k, &lo500, &b051);    // 0-500 | 500-1k @1k
  split_band(lo500, &lo250, &b0255);  // 0-250 | 250-500 @500
  hp80_at500(&lo250);                 // 80-250
  feat[0] = log_energy(lo250);
  feat[1] = log_energy(b0255);
  feat[2] = log_energy(b051);
  feat[3] = log_energy(b12);
  feat[4] = log_energy(b23);
  feat[5] = log_energy(b34);
}

struct Model {
  Gauss noise[6][2];
  Gauss speech[6][2];
  double fmin[6];  // minimum-statistics noise anchor
  int hangover = 0;
  int voiced_streak = 0;

  Model() {
    // Absolute initialization, mirroring the role of the original's
    // trained Q7 tables: noise components at quiet-room levels, speech
    // components spread over conversational band energies.  Like the
    // original, this makes loud stationary noise and tones read as
    // "speech" (webrtcvad's documented false-positive tendency) — the
    // service's default spectral gate (ops/vad.py) rejects those, as an
    // improvement; this classifier is the reference-faithful one.
    for (int ch = 0; ch < 6; ++ch) {
      noise[ch][0] = {-70.0, 7.0};
      noise[ch][1] = {-58.0, 9.0};
      speech[ch][0] = {-48.0, 12.0};
      speech[ch][1] = {-24.0, 12.0};
      fmin[ch] = -70.0;
    }
  }
};

// per-aggressiveness thresholds: {local LLR, global weighted LLR}
static const double kLocalThr[4] = {0.4, 0.6, 0.8, 1.1};
static const double kGlobalThr[4] = {0.8, 1.1, 1.5, 1.9};
// band weights of the global test (speech energy concentrates low)
static const double kBandWeight[6] = {0.25, 0.25, 0.20, 0.15, 0.10, 0.05};
static const double kMinEnergyDb = -75.0;  // hard floor

static double noisemax(const Model* m, int ch) {
  return m->noise[ch][0].mean > m->noise[ch][1].mean ? m->noise[ch][0].mean
                                                     : m->noise[ch][1].mean;
}

static bool classify_and_adapt(Model* m, const double* feat, int aggr) {
  double llr[6];
  double total = 0.0, frame_db = -1e9;
  for (int ch = 0; ch < 6; ++ch) {
    double h0 = log(0.5 * exp(gauss_log_pdf(feat[ch], m->noise[ch][0])) +
                    0.5 * exp(gauss_log_pdf(feat[ch], m->noise[ch][1])) +
                    1e-300);
    double h1 = log(0.5 * exp(gauss_log_pdf(feat[ch], m->speech[ch][0])) +
                    0.5 * exp(gauss_log_pdf(feat[ch], m->speech[ch][1])) +
                    1e-300);
    llr[ch] = h1 - h0;
    total += kBandWeight[ch] * llr[ch];
    if (feat[ch] > frame_db) frame_db = feat[ch];
  }
  bool voiced = false;
  if (frame_db > kMinEnergyDb) {
    for (int ch = 0; ch < 6 && !voiced; ++ch)
      if (llr[ch] > kLocalThr[aggr & 3]) voiced = true;
    if (total > kGlobalThr[aggr & 3]) voiced = true;
  }

  // hangover smoothing (extends speech runs; cannot turn a fully-unvoiced
  // clip voiced because it only triggers after >=2 voiced frames)
  if (voiced) {
    if (++m->voiced_streak >= 2) m->hangover = 4;
  } else {
    m->voiced_streak = 0;
    if (m->hangover > 0) {
      --m->hangover;
      voiced = true;
    }
  }

  // adaptation
  for (int ch = 0; ch < 6; ++ch) {
    double x = feat[ch];
    // minimum statistics with slow upward leak
    m->fmin[ch] = x < m->fmin[ch] ? x : m->fmin[ch] + 0.02;
    if (voiced) {
      int k = fabs(x - m->speech[ch][0].mean) <
                      fabs(x - m->speech[ch][1].mean)
                  ? 0
                  : 1;
      m->speech[ch][k].mean += 0.03 * (x - m->speech[ch][k].mean);
    } else {
      int k = fabs(x - m->noise[ch][0].mean) < fabs(x - m->noise[ch][1].mean)
                  ? 0
                  : 1;
      m->noise[ch][k].mean += 0.03 * (x - m->noise[ch][k].mean);
      // anchor the lower noise component to the tracked minimum
      m->noise[ch][0].mean += 0.05 * (m->fmin[ch] - m->noise[ch][0].mean);
    }
    // enforce speech/noise separation (WebRTC does the same in Q7)
    double nmax = noisemax(m, ch);
    for (int k = 0; k < 2; ++k)
      if (m->speech[ch][k].mean < nmax + 6.0)
        m->speech[ch][k].mean = nmax + 6.0;
  }
  return voiced;
}

// bring a frame to 8 kHz (supports 8/16/32/48 kHz like the original)
static bool to_8k(const float* x, int n, int sample_rate,
                  std::vector<float>* out) {
  std::vector<float> cur(x, x + n);
  int rate = sample_rate;
  while (rate > 8000) {
    if (rate % 2 != 0) return false;
    std::vector<float> lp, hp;
    split_band(cur, &lp, &hp);
    cur.swap(lp);
    rate /= 2;
  }
  if (rate != 8000) return false;
  out->swap(cur);
  return true;
}

}  // namespace gmmvad

// Per-frame voiced flags via the GMM VAD.  Returns the number of frames
// written (<= max_frames), or -1 on unsupported parameters.
int64_t an_vad_gmm_flags(const float* audio, int64_t len, int32_t sample_rate,
                         float frame_ms, int32_t aggressiveness,
                         uint8_t* flags_out, int64_t max_frames) {
  int frame_len = (int)(sample_rate * frame_ms / 1000.0f);
  if (frame_len <= 0) return -1;
  int64_t n_frames = len / frame_len;
  if (n_frames > max_frames) n_frames = max_frames;
  if (n_frames <= 0) return 0;

  gmmvad::Model model;
  std::vector<float> frame8k;
  std::array<double, 6> feat;
  for (int64_t t = 0; t < n_frames; ++t) {
    if (!gmmvad::to_8k(audio + t * frame_len, frame_len, sample_rate,
                       &frame8k))
      return -1;
    gmmvad::frame_features(frame8k, feat.data());
    flags_out[t] =
        gmmvad::classify_and_adapt(&model, feat.data(), aggressiveness)
            ? 1
            : 0;
  }
  return n_frames;
}

// Reference gate semantics over the GMM classifier: 1 = silent.
int an_vad_gmm_is_silent(const float* audio, int64_t len,
                         int32_t sample_rate, float frame_ms,
                         int32_t aggressiveness, float min_speech_seconds) {
  int frame_len = (int)(sample_rate * frame_ms / 1000.0f);
  if (frame_len <= 0) return 1;
  int64_t n_frames = len / frame_len;
  std::vector<uint8_t> flags(n_frames > 0 ? n_frames : 1, 0);
  int64_t n = an_vad_gmm_flags(audio, len, sample_rate, frame_ms,
                               aggressiveness, flags.data(), n_frames);
  if (n < 0) return 1;
  int64_t voiced = 0;
  for (int64_t i = 0; i < n; ++i) voiced += flags[i];
  double speech_seconds = voiced * (frame_ms / 1000.0);
  return speech_seconds < min_speech_seconds ? 1 : 0;
}

// --------------------------------------------------------- quantization ---

// Truncating PCM round trip in place (reference attack: attacks.py:33-70).
void an_pcm_quantize(float* audio, int64_t len, int32_t bits) {
  double scale, lo, hi;
  switch (bits) {
    case 8:  scale = 127.0;      lo = -128;      hi = 127;      break;
    case 12: scale = 4095.0;     lo = -4096;     hi = 4095;     break;
    case 16: scale = 32767.0;    lo = -32768;    hi = 32767;    break;
    case 24: scale = 8388607.0;  lo = -8388608;  hi = 8388607;  break;
    default: return;
  }
  float mx = 0.0f;
  for (int64_t i = 0; i < len; ++i) mx = fmaxf(mx, fabsf(audio[i]));
  // f32 op order mirrors the JAX attack exactly (divide, multiply, clip,
  // truncate) so peak samples land on the same quantization level
  float denom = mx + 1e-8f;
  float fscale = (float)scale;
  for (int64_t i = 0; i < len; ++i) {
    float v = (audio[i] / denom) * fscale;
    if (v > (float)hi) v = (float)hi;
    if (v < (float)lo) v = (float)lo;
    audio[i] = truncf(v) / fscale;
  }
}

// --------------------------------------------------------- batch loader ---

struct AnBatch {
  std::vector<float> data;     // (batch, length) row-major
  std::vector<int64_t> lengths;
  std::vector<int32_t> rates;
  int32_t count = 0;
};

struct AnLoader {
  std::vector<std::string> files;
  int32_t batch, prefetch;
  int64_t length;
  std::atomic<size_t> next_file{0};
  std::queue<AnBatch*> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int64_t> batches_produced{0};
  int64_t batches_total = 0;
  std::mutex assemble_mu;
  std::condition_variable cv_turn;  // building_index moved on
  AnBatch* building = nullptr;
  int64_t building_index = 0;
};

static void loader_worker(AnLoader* L) {
  for (;;) {
    size_t idx = L->next_file.fetch_add(1);
    if (idx >= L->files.size() || L->stop.load()) break;
    AnWavInfo info;
    float* raw = an_read_wav(L->files[idx].c_str(), &info);
    std::vector<float> mono(L->length, 0.0f);
    int64_t n = 0;
    int32_t rate = 0;
    if (raw) {
      n = info.frames < L->length ? info.frames : L->length;
      rate = info.sample_rate;
      if (info.channels == 1) {
        memcpy(mono.data(), raw, n * sizeof(float));
      } else {
        for (int64_t i = 0; i < n; ++i) {
          double acc = 0;
          for (int c = 0; c < info.channels; ++c)
            acc += raw[i * info.channels + c];
          mono[i] = (float)(acc / info.channels);
        }
      }
      an_free(raw);
    }
    // place into the current building batch (ordered by file index so
    // batches are deterministic regardless of thread scheduling)
    std::unique_lock<std::mutex> lk(L->assemble_mu);
    // batches are assembled in file order: slot = idx % batch within
    // batch number idx / batch.  Wait until it's this batch's turn.
    int64_t my_batch = (int64_t)(idx / L->batch);
    L->cv_turn.wait(lk, [L, my_batch] {
      return my_batch == L->building_index || L->stop.load();
    });
    if (L->stop.load()) break;
    if (!L->building) {
      L->building = new AnBatch();
      L->building->data.assign((size_t)L->batch * L->length, 0.0f);
      L->building->lengths.assign(L->batch, 0);
      L->building->rates.assign(L->batch, 0);
    }
    int32_t slot = (int32_t)(idx % L->batch);
    memcpy(L->building->data.data() + (size_t)slot * L->length, mono.data(),
           L->length * sizeof(float));
    L->building->lengths[slot] = n;
    L->building->rates[slot] = rate;
    L->building->count++;
    // A batch closes when every one of its files is in, whatever order
    // they came in.  (The JAX package's loader also closed it when the
    // last file of the dataset came in: a worker still reading an earlier
    // file of a short final batch then found the batch gone and its slot
    // was lost.)
    int64_t in_batch = (int64_t)L->files.size() - my_batch * L->batch;
    if (in_batch > L->batch) in_batch = L->batch;
    if (L->building->count == in_batch) {
      AnBatch* done = L->building;
      L->building = nullptr;
      L->building_index++;
      lk.unlock();
      L->cv_turn.notify_all();
      std::unique_lock<std::mutex> qk(L->mu);
      L->cv_space.wait(qk, [L] {
        return (int32_t)L->ready.size() < L->prefetch || L->stop.load();
      });
      L->ready.push(done);
      L->cv_ready.notify_all();
    }
  }
}

AnLoader* an_loader_create(const char** paths, int32_t n_files,
                           int32_t batch, int64_t length,
                           int32_t n_threads, int32_t prefetch) {
  AnLoader* L = new AnLoader();
  for (int32_t i = 0; i < n_files; ++i) L->files.emplace_back(paths[i]);
  L->batch = batch;
  L->length = length;
  L->prefetch = prefetch > 0 ? prefetch : 2;
  L->batches_total = (n_files + batch - 1) / batch;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(loader_worker, L);
  return L;
}

// Copies the next batch into caller buffers.  Returns the number of valid
// clips in the batch, or -1 when the dataset is exhausted.
int32_t an_loader_next(AnLoader* L, float* out_data, int64_t* out_lengths,
                       int32_t* out_rates) {
  {
    std::unique_lock<std::mutex> lk(L->mu);
    if (L->ready.empty() &&
        L->batches_produced.load() >= L->batches_total)
      return -1;
    L->cv_ready.wait(lk, [L] { return !L->ready.empty() || L->stop.load(); });
    if (L->ready.empty()) return -1;
    AnBatch* b = L->ready.front();
    L->ready.pop();
    L->cv_space.notify_all();
    lk.unlock();
    memcpy(out_data, b->data.data(),
           (size_t)L->batch * L->length * sizeof(float));
    memcpy(out_lengths, b->lengths.data(), L->batch * sizeof(int64_t));
    memcpy(out_rates, b->rates.data(), L->batch * sizeof(int32_t));
    int32_t cnt = b->count;
    delete b;
    L->batches_produced.fetch_add(1);
    return cnt;
  }
}

void an_loader_destroy(AnLoader* L) {
  L->stop.store(true);
  // take each waiter's mutex once, so that none is between its check of
  // stop and its wait when the notify comes
  { std::lock_guard<std::mutex> g(L->assemble_mu); }
  { std::lock_guard<std::mutex> g(L->mu); }
  L->cv_turn.notify_all();
  L->cv_ready.notify_all();
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  while (!L->ready.empty()) {
    delete L->ready.front();
    L->ready.pop();
  }
  delete L->building;
  delete L;
}

}  // extern "C"
