// aware_tpu_torch real-codec shim: an encoder -> decoder round trip through
// the system FFmpeg libraries (libavcodec 59 / libavutil 57 /
// libswresample 4, FFmpeg 5.1).
//
// The port's own copy of the JAX package's shim
// (aware_tpu/_native/aware_codecs.cc).  Host code, not a device kernel.
// The reference's only lossy-codec attack is MP3 (reference:
// scripts/attacks.py:73-148, shelling out to the ffmpeg BINARY).  The
// ffmpeg *libraries* with their dev headers are enough to run any
// encoder/decoder pair fully in-process: raw packets go straight from
// avcodec_send_frame/receive_packet into avcodec_send_packet/receive_frame
// on a paired decoder — no container, no muxer, no temp files.  Sample-rate
// and format conversion on both legs is libswresample, so a 16 kHz mono
// float clip can cross codecs pinned to other rates (e.g. Speex 8 kHz) and
// come back at 16 kHz.
//
// Exposed C API (ctypes-consumed by aware_tpu_torch/attacks/av_codecs.py):
//   aware_avc_has(name)          -> 1 if encoder AND a matching decoder load
//   aware_avc_roundtrip(...)     -> n_out samples at the input rate, or <0
//
// Built at first use by aware_tpu_torch/attacks/av_codecs.py:
//   g++ -O3 -std=c++17 -fPIC -pthread -shared ... -lavcodec -lavutil -lswresample

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavutil/channel_layout.h>
#include <libavutil/log.h>
#include <libavutil/opt.h>
#include <libavutil/samplefmt.h>
#include <libswresample/swresample.h>
}

#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Smallest supported rate >= want, else the largest supported; `want`
// itself when the encoder accepts any rate.
int pick_rate(const AVCodec* c, int want) {
  if (!c->supported_samplerates) return want;
  int up = INT_MAX, down = 0;
  for (const int* r = c->supported_samplerates; *r; ++r) {
    if (*r == want) return want;
    if (*r > want) up = (*r < up) ? *r : up;
    else down = (*r > down) ? *r : down;
  }
  return up != INT_MAX ? up : down;
}

AVSampleFormat pick_fmt(const AVCodec* c) {
  if (!c->sample_fmts) return AV_SAMPLE_FMT_FLT;
  static const AVSampleFormat prefs[] = {
      AV_SAMPLE_FMT_FLTP, AV_SAMPLE_FMT_FLT, AV_SAMPLE_FMT_S16,
      AV_SAMPLE_FMT_S16P, AV_SAMPLE_FMT_DBLP, AV_SAMPLE_FMT_DBL,
  };
  for (AVSampleFormat p : prefs)
    for (const AVSampleFormat* f = c->sample_fmts; *f != AV_SAMPLE_FMT_NONE;
         ++f)
      if (*f == p) return p;
  return c->sample_fmts[0];
}

// Owns every libav object so all exit paths clean up.
struct Ctx {
  AVCodecContext* ec = nullptr;
  AVCodecContext* dc = nullptr;
  SwrContext* swr_in = nullptr;
  SwrContext* swr_out = nullptr;
  AVFrame* ef = nullptr;
  AVFrame* df = nullptr;
  AVPacket* pkt = nullptr;
  ~Ctx() {
    if (ec) avcodec_free_context(&ec);
    if (dc) avcodec_free_context(&dc);
    if (swr_in) swr_free(&swr_in);
    if (swr_out) swr_free(&swr_out);
    if (ef) av_frame_free(&ef);
    if (df) av_frame_free(&df);
    if (pkt) av_packet_free(&pkt);
  }
};

struct Sink {
  float* out;
  int cap;
  int n = 0;
  bool overflow = false;
  void put(const float* src, int count) {
    if (n + count > cap) {
      count = cap - n;
      overflow = true;
    }
    if (count > 0) {
      std::memcpy(out + n, src, sizeof(float) * count);
      n += count;
    }
  }
};

// Convert one decoded frame back to mono float at `out_rate` and append.
int drain_decoded(Ctx& c, AVFrame* df, int out_rate, Sink& sink,
                  std::vector<float>& scratch) {
  if (!c.swr_out) {
    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    int rc = swr_alloc_set_opts2(
        &c.swr_out, &mono, AV_SAMPLE_FMT_FLT, out_rate, &df->ch_layout,
        (AVSampleFormat)df->format, df->sample_rate, 0, nullptr);
    if (rc < 0 || swr_init(c.swr_out) < 0) return AVERROR(EINVAL);
  }
  int max_out =
      (int)av_rescale_rnd(df->nb_samples + 4096, out_rate, df->sample_rate,
                          AV_ROUND_UP);
  if ((int)scratch.size() < max_out) scratch.resize(max_out);
  uint8_t* outp = (uint8_t*)scratch.data();
  int got = swr_convert(c.swr_out, &outp, max_out,
                        (const uint8_t**)df->extended_data, df->nb_samples);
  if (got < 0) return got;
  sink.put(scratch.data(), got);
  return 0;
}

int pump_decoder(Ctx& c, const AVPacket* pkt, int out_rate, Sink& sink,
                 std::vector<float>& scratch) {
  int rc = avcodec_send_packet(c.dc, pkt);
  if (rc < 0 && rc != AVERROR_EOF) return rc;
  while (true) {
    rc = avcodec_receive_frame(c.dc, c.df);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    rc = drain_decoded(c, c.df, out_rate, sink, scratch);
    av_frame_unref(c.df);
    if (rc < 0) return rc;
  }
}

int pump_encoder(Ctx& c, const AVFrame* frame, int out_rate, Sink& sink,
                 std::vector<float>& scratch) {
  int rc = avcodec_send_frame(c.ec, frame);
  if (rc < 0 && rc != AVERROR_EOF) return rc;
  while (true) {
    rc = avcodec_receive_packet(c.ec, c.pkt);
    if (rc == AVERROR(EAGAIN)) return 0;
    if (rc == AVERROR_EOF) {
      // encoder fully drained: flush the decoder too
      return pump_decoder(c, nullptr, out_rate, sink, scratch);
    }
    if (rc < 0) return rc;
    rc = pump_decoder(c, c.pkt, out_rate, sink, scratch);
    av_packet_unref(c.pkt);
    if (rc < 0) return rc;
  }
}

}  // namespace

extern "C" {

int aware_avc_has(const char* codec_name) {
  const AVCodec* e = avcodec_find_encoder_by_name(codec_name);
  if (!e) return 0;
  return avcodec_find_decoder(e->id) != nullptr;
}

// Mono float32 in [-1,1] at `in_rate` -> encode -> decode -> mono float32
// at `in_rate`.  bit_rate<=0 with q_scale>=0 selects the encoder's VBR
// quality mode (AV_CODEC_FLAG_QSCALE); both <=0 means codec defaults.
// Returns samples written to `out` (codec delay included — the Python
// side aligns by cross-correlation), or a negative AVERROR.
int aware_avc_roundtrip(const char* codec_name, int in_rate,
                        long long bit_rate, double q_scale, const float* in,
                        int n_in, float* out, int out_cap) {
  if (n_in <= 0 || out_cap <= 0) return AVERROR(EINVAL);
  av_log_set_level(AV_LOG_ERROR);  // Qavg/queue chatter is not actionable
  const AVCodec* enc = avcodec_find_encoder_by_name(codec_name);
  if (!enc) return AVERROR_ENCODER_NOT_FOUND;
  const AVCodec* dec = avcodec_find_decoder(enc->id);
  if (!dec) return AVERROR_DECODER_NOT_FOUND;

  Ctx c;
  c.ec = avcodec_alloc_context3(enc);
  c.dc = avcodec_alloc_context3(dec);
  c.ef = av_frame_alloc();
  c.df = av_frame_alloc();
  c.pkt = av_packet_alloc();
  if (!c.ec || !c.dc || !c.ef || !c.df || !c.pkt) return AVERROR(ENOMEM);

  const int enc_rate = pick_rate(enc, in_rate);
  const AVSampleFormat enc_fmt = pick_fmt(enc);
  c.ec->sample_rate = enc_rate;
  c.ec->sample_fmt = enc_fmt;
  av_channel_layout_default(&c.ec->ch_layout, 1);
  c.ec->time_base = {1, enc_rate};
  if (bit_rate > 0) {
    c.ec->bit_rate = bit_rate;
  } else if (q_scale >= 0.0) {
    c.ec->flags |= AV_CODEC_FLAG_QSCALE;
    c.ec->global_quality = (int)(FF_QP2LAMBDA * q_scale);
  }
  // raw-packet decode needs the codec headers out-of-band (vorbis/aac)
  c.ec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  c.ec->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
  int rc = avcodec_open2(c.ec, enc, nullptr);
  if (rc < 0) return rc;

  c.dc->sample_rate = c.ec->sample_rate;
  av_channel_layout_default(&c.dc->ch_layout, 1);
  if (c.ec->extradata_size > 0) {
    c.dc->extradata = (uint8_t*)av_mallocz(c.ec->extradata_size +
                                           AV_INPUT_BUFFER_PADDING_SIZE);
    if (!c.dc->extradata) return AVERROR(ENOMEM);
    std::memcpy(c.dc->extradata, c.ec->extradata, c.ec->extradata_size);
    c.dc->extradata_size = c.ec->extradata_size;
  }
  rc = avcodec_open2(c.dc, dec, nullptr);
  if (rc < 0) return rc;

  // ---- input leg: mono float @ in_rate -> enc_fmt @ enc_rate ----
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  rc = swr_alloc_set_opts2(&c.swr_in, &mono, enc_fmt, enc_rate, &mono,
                           AV_SAMPLE_FMT_FLT, in_rate, 0, nullptr);
  if (rc < 0 || swr_init(c.swr_in) < 0) return AVERROR(EINVAL);

  const int frame_sz = c.ec->frame_size > 0 ? c.ec->frame_size : 1024;
  const int bps = av_get_bytes_per_sample(enc_fmt);
  int64_t max_enc_in =
      av_rescale_rnd(n_in, enc_rate, in_rate, AV_ROUND_UP) + 8192;
  // round up to whole frames so the tail frame is silence-padded
  max_enc_in = ((max_enc_in + frame_sz - 1) / frame_sz) * frame_sz;
  std::vector<uint8_t> enc_in((size_t)max_enc_in * bps, 0);

  uint8_t* dst = enc_in.data();
  const uint8_t* src = (const uint8_t*)in;
  int filled = swr_convert(c.swr_in, &dst, (int)max_enc_in, &src, n_in);
  if (filled < 0) return filled;
  uint8_t* dst2 = enc_in.data() + (size_t)filled * bps;
  int tail = swr_convert(c.swr_in, &dst2, (int)(max_enc_in - filled),
                         nullptr, 0);
  if (tail < 0) return tail;
  const int64_t n_frames = ((int64_t)filled + tail + frame_sz - 1) / frame_sz;

  Sink sink{out, out_cap};
  std::vector<float> scratch;

  for (int64_t i = 0; i < n_frames; ++i) {
    c.ef->nb_samples = frame_sz;
    c.ef->format = enc_fmt;
    c.ef->sample_rate = enc_rate;
    av_channel_layout_default(&c.ef->ch_layout, 1);
    rc = av_frame_get_buffer(c.ef, 0);
    if (rc < 0) return rc;
    std::memcpy(c.ef->data[0], enc_in.data() + (size_t)i * frame_sz * bps,
                (size_t)frame_sz * bps);
    c.ef->pts = i * frame_sz;
    rc = pump_encoder(c, c.ef, in_rate, sink, scratch);
    av_frame_unref(c.ef);
    if (rc < 0) return rc;
  }
  rc = pump_encoder(c, nullptr, in_rate, sink, scratch);  // flush both
  if (rc < 0) return rc;
  if (c.swr_out) {  // drain the output resampler's tail
    int max_out = 8192;
    if ((int)scratch.size() < max_out) scratch.resize(max_out);
    uint8_t* outp = (uint8_t*)scratch.data();
    int got = swr_convert(c.swr_out, &outp, max_out, nullptr, 0);
    if (got > 0) sink.put(scratch.data(), got);
  }
  // A truncated decode must surface as an error, never as success with a
  // silently clipped tail (the Python caller sizes out_cap heuristically).
  if (sink.overflow) return AVERROR(ENOSPC);
  return sink.n;
}

}  // extern "C"
