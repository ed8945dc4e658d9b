// Native streaming host of the port: plays a streaming artifact of
// after_tpu_torch (streaming/export.py) buffer by buffer in a process without
// Python, on the card unless asked for the CPU.  The counterpart of
// native/stream_host.cc, which plays the JAX package's artifacts through the
// PJRT C API; both stand where the reference's nn~ external runs its
// TorchScript export from the audio thread.
//
// Usage (the JAX host's arguments without <pjrt_plugin.so>):
//   stream_host <artifact> <structure.wav> <timbre.wav> <out.wav>
//               [n_chunks] [nb_steps] [guidance_timbre] [guidance_structure]
//   stream_host <artifact> --pcm [nb_steps] [guidance_timbre]
//               [guidance_structure]        (2ch f32 on stdin, mono f32 out)
//   stream_host <codec_artifact> <in.wav> <out.wav> [n_chunks]
//   stream_host <codec_artifact> --pcm      (mono f32 in, mono f32 out)
// A MIDI artifact takes a raw f32 notes file (n_frames, n_poly, 2) in place
// of the structure WAV; an artifact of B voices takes comma-separated lists
// of B files.  Flags, anywhere:
//   --device cuda|cpu   where the stages run (default cuda; without a card
//                       the host exits non-zero, it never falls back)
//   --x0 <file>         the sampler's noise, raw f32 (n_chunks, B, chunk, C);
//                       without it the host draws it from a generator seeded
//                       0 on the serving device, as ExportedStreamer does
// Environment: AFTER_NATIVE_CTRL (a file or FIFO of "name value" lines,
// polled between buffers; "@N name value" applies from buffer N),
// AFTER_NATIVE_PIPELINE (readback depth, default 2).
//
// The stages: each stage program of the artifact is packaged ahead of time
// with AOTInductor (streaming/native.py: native/<device>/<stage>.pt2, named
// in the manifest), in a pure form: it takes the stream state's leaves and
// the stage's inputs and returns its output and the new values of the leaves
// it writes, which the host copies back into the state.  The snake+conv
// convs in them call the op after_tpu_torch::snake_conv, registered from C++
// by the op library this host links (snake_conv_op.cc): on the card it
// launches the kernel of fused_snake_conv.cu, on the CPU the plain version.
// On the card each stage is captured once as a CUDA graph at load, after a
// warm-up whose writes to the state are undone, and a buffer replays 3 +
// nb_steps graphs; nb_steps and the guidances reach the step graphs as
// device scalars, so changing them captures nothing.
//
// Output WAVs are 32-bit float (the JAX host writes clipped PCM16).  At the
// end the host prints, on stderr, its ms a buffer and per phase, each
// buffer's ms, and the kernel launches the device counted.

#include <ATen/ATen.h>
#include <ATen/CPUGeneratorImpl.h>
#include <c10/core/GradMode.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <functional>
#include <iostream>
#include <limits>
#include <map>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

#ifdef AFTER_TPU_TORCH_CUDA
#include <ATen/cuda/CUDAContext.h>
#include <ATen/cuda/CUDAEvent.h>
#include <ATen/cuda/CUDAGeneratorImpl.h>
#include <ATen/cuda/CUDAGraph.h>
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAGuard.h>
#endif

#ifdef AFTER_TPU_TORCH_CUDA
namespace after_tpu_torch {
// snake_conv_op.cc: the kernel's four launch counters on a card (f32 conv
// and split sum, bf16 conv and split sum)
at::Tensor device_counts(c10::DeviceIndex device);
}  // namespace after_tpu_torch
#endif

namespace after_tpu_torch {
// snake_conv_op.cc: calls of the op's plain version on the CPU
int64_t cpu_calls();
}  // namespace after_tpu_torch

namespace {

// ---------------------------------------------------------------------------
// small utilities (copied from native/stream_host.cc)
// ---------------------------------------------------------------------------

[[noreturn]] void Die(const std::string& msg) {
  std::cerr << "[stream_host] " << msg << "\n";
  exit(1);
}

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot open " + path);
  std::stringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

// Minimal JSON value extraction (the manifest is machine-written).  Only a
// `"key": <int>` occurrence counts: the key string may also appear as a
// VALUE elsewhere (e.g. "nb_steps" inside a method's attributes list), so
// require the colon to immediately follow the closing quote.
int64_t JsonInt(const std::string& j, const std::string& key, int64_t dflt) {
  const std::string quoted = "\"" + key + "\"";
  size_t pos = 0;
  while ((pos = j.find(quoted, pos)) != std::string::npos) {
    size_t p = pos + quoted.size();
    while (p < j.size() && (j[p] == ' ' || j[p] == '\n')) ++p;
    if (p < j.size() && j[p] == ':') {
      ++p;
      while (p < j.size() && (j[p] == ' ' || j[p] == '\n')) ++p;
      if (p < j.size() && ((j[p] >= '0' && j[p] <= '9') || j[p] == '-')) {
        return std::strtoll(j.c_str() + p, nullptr, 10);
      }
    }
    pos += quoted.size();
  }
  return dflt;
}

// Parse "state_shapes": [[..],[..]] and "state_dtypes": ["float32",...]
std::vector<std::vector<int64_t>> JsonShapeList(const std::string& j,
                                                const std::string& key) {
  std::vector<std::vector<int64_t>> out;
  auto pos = j.find("\"" + key + "\"");
  if (pos == std::string::npos) return out;
  pos = j.find('[', pos);
  size_t depth = 1;
  size_t i = pos + 1;
  std::vector<int64_t> cur;
  std::string num;
  bool in_inner = false;
  for (; i < j.size() && depth > 0; ++i) {
    char c = j[i];
    if (c == '[') {
      depth++;
      in_inner = true;
      cur.clear();
    } else if (c == ']' || c == ',') {
      if (!num.empty()) {
        cur.push_back(std::strtoll(num.c_str(), nullptr, 10));
        num.clear();
      }
      if (c == ']') {
        depth--;
        if (in_inner && depth >= 1) {
          out.push_back(cur);
          in_inner = false;
        }
      }
    } else if ((c >= '0' && c <= '9') || c == '-') {
      num += c;
    }
  }
  return out;
}

std::vector<std::string> JsonStringList(const std::string& j,
                                        const std::string& key) {
  std::vector<std::string> out;
  auto pos = j.find("\"" + key + "\"");
  if (pos == std::string::npos) return out;
  pos = j.find('[', pos);
  auto end = j.find(']', pos);
  size_t i = pos;
  while (true) {
    auto q1 = j.find('"', i + 1);
    if (q1 == std::string::npos || q1 > end) break;
    auto q2 = j.find('"', q1 + 1);
    out.push_back(j.substr(q1 + 1, q2 - q1 - 1));
    i = q2;
  }
  return out;
}

// `"key": "<text>"` as its text, or dflt, the same colon rule as JsonInt.
std::string JsonString(const std::string& j, const std::string& key,
                       const std::string& dflt) {
  const std::string quoted = "\"" + key + "\"";
  size_t pos = 0;
  while ((pos = j.find(quoted, pos)) != std::string::npos) {
    size_t p = pos + quoted.size();
    while (p < j.size() && (j[p] == ' ' || j[p] == '\n')) ++p;
    if (p < j.size() && j[p] == ':') {
      ++p;
      while (p < j.size() && (j[p] == ' ' || j[p] == '\n')) ++p;
      if (p < j.size() && j[p] == '"') {
        const size_t end = j.find('"', p + 1);
        if (end != std::string::npos) return j.substr(p + 1, end - p - 1);
      }
    }
    pos += quoted.size();
  }
  return dflt;
}

// `"key": <number>` as a double, the same colon rule as JsonInt.
double JsonDouble(const std::string& j, const std::string& key, double dflt) {
  const std::string quoted = "\"" + key + "\"";
  size_t pos = 0;
  while ((pos = j.find(quoted, pos)) != std::string::npos) {
    size_t p = pos + quoted.size();
    while (p < j.size() && (j[p] == ' ' || j[p] == '\n')) ++p;
    if (p < j.size() && j[p] == ':') {
      ++p;
      while (p < j.size() && (j[p] == ' ' || j[p] == '\n')) ++p;
      if (p < j.size() && ((j[p] >= '0' && j[p] <= '9') || j[p] == '-'))
        return std::strtod(j.c_str() + p, nullptr);
    }
    pos += quoted.size();
  }
  return dflt;
}

// The text of the object `"key": {...}` (its braces included), or "": the
// key followed by a colon and a brace, as JsonInt wants its colon.
std::string JsonObject(const std::string& j, const std::string& key) {
  const std::string quoted = "\"" + key + "\"";
  size_t pos = 0;
  while ((pos = j.find(quoted, pos)) != std::string::npos) {
    size_t p = pos + quoted.size();
    while (p < j.size() && (j[p] == ' ' || j[p] == '\n')) ++p;
    if (p < j.size() && j[p] == ':') {
      ++p;
      while (p < j.size() && (j[p] == ' ' || j[p] == '\n')) ++p;
      if (p < j.size() && j[p] == '{') {
        int depth = 0;
        for (size_t i = p; i < j.size(); ++i) {
          if (j[i] == '{') depth++;
          if (j[i] == '}' && --depth == 0) return j.substr(p, i - p + 1);
        }
      }
    }
    pos += quoted.size();
  }
  return "";
}

// ---------------------------------------------------------------------------
// WAV IO: reads PCM16 or f32, mono (first channel); writes f32 mono
// ---------------------------------------------------------------------------

struct Wav {
  int sr = 44100;
  std::vector<float> samples;
};

Wav ReadWav(const std::string& path) {
  std::string d = ReadFile(path);
  Wav w;
  if (d.size() < 44 || std::memcmp(d.data(), "RIFF", 4) != 0)
    Die("bad wav " + path);
  uint16_t channels, bits;
  uint32_t sr;
  std::memcpy(&channels, d.data() + 22, 2);
  std::memcpy(&sr, d.data() + 24, 4);
  std::memcpy(&bits, d.data() + 34, 2);
  w.sr = sr;
  // find data chunk
  size_t pos = 12;
  while (pos + 8 < d.size()) {
    uint32_t len;
    std::memcpy(&len, d.data() + pos + 4, 4);
    if (std::memcmp(d.data() + pos, "data", 4) == 0) {
      const char* p = d.data() + pos + 8;
      size_t n = len / (bits / 8) / channels;
      w.samples.resize(n);
      for (size_t i = 0; i < n; ++i) {
        if (bits == 16) {
          int16_t v;
          std::memcpy(&v, p + (i * channels) * 2, 2);
          w.samples[i] = v / 32768.0f;
        } else if (bits == 32) {
          float v;
          std::memcpy(&v, p + (i * channels) * 4, 4);
          w.samples[i] = v;
        }
      }
      return w;
    }
    pos += 8 + len + (len & 1);
  }
  Die("no data chunk in " + path);
}

void WriteWav(const std::string& path, const std::vector<float>& x, int sr) {
  std::ofstream f(path, std::ios::binary);
  const uint32_t data_len = x.size() * 4;
  const uint32_t riff_len = 36 + data_len, fmt_len = 16;
  const uint16_t ieee_float = 3, ch = 1, bits = 32, block = 4;
  const uint32_t rate = sr, byte_rate = sr * 4;
  f.write("RIFF", 4);
  f.write(reinterpret_cast<const char*>(&riff_len), 4);
  f.write("WAVEfmt ", 8);
  f.write(reinterpret_cast<const char*>(&fmt_len), 4);
  f.write(reinterpret_cast<const char*>(&ieee_float), 2);
  f.write(reinterpret_cast<const char*>(&ch), 2);
  f.write(reinterpret_cast<const char*>(&rate), 4);
  f.write(reinterpret_cast<const char*>(&byte_rate), 4);
  f.write(reinterpret_cast<const char*>(&block), 2);
  f.write(reinterpret_cast<const char*>(&bits), 2);
  f.write("data", 4);
  f.write(reinterpret_cast<const char*>(&data_len), 4);
  f.write(reinterpret_cast<const char*>(x.data()), data_len);
}

at::ScalarType DtypeOf(const std::string& name) {
  if (name == "float32") return at::kFloat;
  // a bf16 leaf's .bin holds its raw 2-byte values
  if (name == "bfloat16") return at::kBFloat16;
  if (name == "int32") return at::kInt;
  if (name == "int64") return at::kLong;
  if (name == "uint8") return at::kByte;
  if (name == "bool") return at::kBool;
  Die("unsupported state dtype " + name);
}

// ---------------------------------------------------------------------------
// the runtime scalars (diffusion/rectified_flow.py:stream_scalars,
// guidance_mix), in f32 as written there
// ---------------------------------------------------------------------------

int StreamScalars(int max_steps, int nb_steps, double guidance_timbre,
                  double guidance_structure, float* out) {
  const int nb = std::min(std::max(nb_steps, 1), max_steps);
  const float nb_f = static_cast<float>(nb);
  for (int i = 0; i < max_steps; ++i) out[i] = static_cast<float>(i) / nb_f;
  out[max_steps] = 1.0f / nb_f;
  const float gt = static_cast<float>(guidance_timbre);
  const float gs = static_cast<float>(guidance_structure);
  out[max_steps + 1] = 0.5f * (gs + gt);
  out[max_steps + 2] = gt / std::max(gs, 0.01f);
  return nb;
}

// ---------------------------------------------------------------------------
// the stages
// ---------------------------------------------------------------------------

struct Stage {
  std::string name;
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> pkg;
  std::vector<int64_t> writes;  // state leaves its outputs 1.. replace
  bool stateful = true;
};

double Median(std::vector<double> v, double q) {
  if (v.empty()) return 0;
  std::sort(v.begin(), v.end());
  size_t i = static_cast<size_t>(q * (v.size() - 1) + 0.5);
  return v[std::min(i, v.size() - 1)];
}

}  // namespace

int main(int argc, char** argv) {
  // flags first, anywhere on the line; the rest is native/stream_host.cc's
  // positional arguments without the plugin
  bool pcm_mode = false;
  std::string device_name = "cuda", x0_path;
  std::vector<char*> pos;
  for (int i = 0; i < argc; ++i) {
    const std::string a = argv[i];
    if (a == "--pcm") {
      pcm_mode = true;
    } else if ((a == "--device" || a == "--x0") && i + 1 < argc) {
      (a == "--device" ? device_name : x0_path) = argv[++i];
    } else {
      pos.push_back(argv[i]);
    }
  }
  argc = static_cast<int>(pos.size());
  argv = pos.data();
  if (argc < 3 && !(pcm_mode && argc == 2)) {
    std::cerr
        << "usage: stream_host <artifact_dir> <structure.wav> <timbre.wav> "
           "<out.wav> [n_chunks] [nb_steps] [guidance_timbre] "
           "[guidance_structure]\n"
           "   or: stream_host <artifact_dir> --pcm [nb_steps] "
           "[guidance_timbre] [guidance_structure]\n"
           "       (interleaved 2ch f32 PCM on stdin -> mono f32 on stdout)\n"
           "   or: stream_host <codec_artifact> <in.wav> <out.wav> "
           "[n_chunks]   (codec-only artifact)\n"
           "   or: stream_host <codec_artifact> --pcm   (mono f32 in -> mono "
           "f32 out)\n"
           "flags: --device cuda|cpu (default cuda), --x0 <noise.f32>\n";
    return 1;
  }
  if (device_name != "cuda" && device_name != "cpu")
    Die("--device must be cuda or cpu, not " + device_name);
  const bool on_card = device_name == "cuda";
  if (on_card && !at::hasCUDA())
    Die("no CUDA device: pass --device cpu to run the stages' plain "
        "versions on the CPU");
#ifndef AFTER_TPU_TORCH_CUDA
  if (on_card)
    Die("this host was built without CUDA (no nvcc at build time): pass "
        "--device cpu");
#endif
  const c10::AutoGradMode no_grad(false);
  // strict f32 on the card: no TF32 in cuBLAS or cuDNN
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setAllowTF32CuDNN(false);
  const at::Device device = on_card ? at::Device(at::kCUDA, 0)
                                    : at::Device(at::kCPU);
  if (!on_card) {
    // PyTorch's first vectorised sin (cos, exp, tanh) of a CPU process may
    // compute one thread's share of a large tensor about 1.5e-4 off; after
    // one call on another tensor it is exact to f32 (the port's
    // utils/device.py:warm_cpu_math, scripts/torch_cpu_first_call.py)
    const at::Tensor w = at::linspace(-4.0, 4.0, 1 << 16);
    at::sin(w), at::cos(w), at::exp(w), at::tanh(w);
  }
  const auto f32 = at::TensorOptions().dtype(at::kFloat).device(device);

  std::string art = argv[1];
  std::string manifest = ReadFile(art + "/manifest.json");
  // StreamScalars computes the rectified flow's step scalars only: an EDM
  // artifact's steps read its Karras ladder, which this host does not make
  // (the manifest's config names the model's diffusion_type)
  const std::string diffusion_type =
      JsonString(manifest, "diffusion_type", "rectified");
  if (diffusion_type != "rectified") {
    std::cerr << "diffusion_type \"" << diffusion_type
              << "\": this host computes the rectified flow's step scalars "
                 "only (EDM's Karras ladder is not ported to the native "
                 "host); serve the artifact with the Python host "
                 "(after_tpu_torch.streaming.export.ExportedStreamer)\n";
    return 1;
  }
  // codec-only artifacts (after-tpu-torch export_autoencoder): one audio
  // input streamed through the fused decode(encode(x)) `forward`
  bool codec_mode = JsonInt(manifest, "codec_only", 0) != 0;
  if (argc < (pcm_mode ? 2 : codec_mode ? 4 : 5)) {
    std::cerr << "artifact is " << (codec_mode ? "codec-only" : "a2a/midi")
              << ": expected " << (codec_mode ? "<in.wav> <out.wav>"
                                              : "<structure> <timbre> <out>")
              << " (run with no file args for usage)\n";
    return 1;
  }
  int64_t audio_chunk = JsonInt(manifest, "audio_chunk", 8192);
  int64_t chunk = JsonInt(manifest, "chunk_size", 4);
  int64_t sr = JsonInt(manifest, "sr", 44100);
  // n_poly > 0 marks a MIDI artifact: argv[2] is then a raw float32 notes
  // file of shape (n_frames, n_poly, 2) instead of the structure WAV
  int64_t n_poly = JsonInt(manifest, "n_poly", 0);
  bool midi_mode = n_poly > 0;
  // batched-voice artifacts (export_streamer(batch_size=B)): inputs and
  // outputs are comma-separated per-voice file lists
  int64_t n_voices = JsonInt(manifest, "batch_size", 1);
  if (pcm_mode && midi_mode) {
    std::cerr << "--pcm is audio-to-audio only; MIDI artifacts take a "
                 "notes file (see scripts/midi_to_notes.py)\n";
    return 1;
  }
  if (pcm_mode && n_voices != 1) {
    std::cerr << "--pcm supports batch_size=1 artifacts only\n";
    return 1;
  }
  if (codec_mode && midi_mode) {
    std::cerr << "manifest is both codec_only and midi (n_poly > 0)?\n";
    return 1;
  }

  auto split_list = [](const std::string& s) {
    std::vector<std::string> out;
    size_t p = 0, q;
    while ((q = s.find(',', p)) != std::string::npos) {
      out.push_back(s.substr(p, q - p));
      p = q + 1;
    }
    out.push_back(s.substr(p));
    return out;
  };

  std::vector<Wav> in_struct, in_timbre;
  std::vector<std::vector<float>> notes_all;  // per voice
  std::vector<std::string> out_paths;
  if (codec_mode && !pcm_mode) {
    auto s_list = split_list(argv[2]);
    out_paths = split_list(argv[3]);
    if (static_cast<int64_t>(s_list.size()) != n_voices ||
        static_cast<int64_t>(out_paths.size()) != n_voices) {
      std::cerr << "artifact batch_size=" << n_voices << ": need "
                << n_voices << " comma-separated in/out files\n";
      return 1;
    }
    for (int64_t v = 0; v < n_voices; ++v)
      in_struct.push_back(ReadWav(s_list[v]));
  } else if (!pcm_mode) {
    auto s_list = split_list(argv[2]);
    auto t_list = split_list(argv[3]);
    out_paths = split_list(argv[4]);
    if (static_cast<int64_t>(s_list.size()) != n_voices ||
        static_cast<int64_t>(t_list.size()) != n_voices ||
        static_cast<int64_t>(out_paths.size()) != n_voices) {
      std::cerr << "artifact batch_size=" << n_voices << ": need "
                << n_voices << " comma-separated structure/timbre/out "
                << "files\n";
      return 1;
    }
    for (int64_t v = 0; v < n_voices; ++v) {
      if (midi_mode) {
        std::string raw = ReadFile(s_list[v]);
        notes_all.emplace_back(raw.size() / 4);
        std::memcpy(notes_all.back().data(), raw.data(),
                    notes_all.back().size() * 4);
      } else {
        in_struct.push_back(ReadWav(s_list[v]));
      }
      in_timbre.push_back(ReadWav(t_list[v]));
    }
  }
  int64_t n_leaves = JsonInt(manifest, "n_state_leaves", 0);
  auto shapes = JsonShapeList(manifest, "state_shapes");
  auto dtypes = JsonStringList(manifest, "state_dtypes");
  if (static_cast<int64_t>(shapes.size()) != n_leaves ||
      static_cast<int64_t>(dtypes.size()) != n_leaves)
    Die("manifest: state_shapes / state_dtypes do not match n_state_leaves");

  int64_t n_chunks = -1;  // pcm mode: stream until stdin EOF
  if (!pcm_mode) {
    n_chunks = std::numeric_limits<int64_t>::max();
    for (int64_t v = 0; v < n_voices; ++v) {
      int64_t struct_chunks =
          midi_mode ? static_cast<int64_t>(notes_all[v].size()) /
                          (n_poly * 2 * chunk)
                    : static_cast<int64_t>(in_struct[v].samples.size()) /
                          audio_chunk;
      n_chunks = std::min(n_chunks, struct_chunks);
      if (!codec_mode)
        n_chunks = std::min(
            n_chunks,
            static_cast<int64_t>(in_timbre[v].samples.size()) / audio_chunk);
    }
    int nc_arg = codec_mode ? 4 : 5;
    if (argc > nc_arg)
      n_chunks = std::min<int64_t>(n_chunks, std::atoi(argv[nc_arg]));
  }

  // runtime attributes: nb_steps and the two guidances, read by the step
  // stage as device scalars; CLI: [nb_steps] [guidance_timbre]
  // [guidance_structure] after n_chunks (file mode) or after --pcm
  const std::string attrs = JsonObject(manifest, "attributes");
  int32_t attr_nb_steps = static_cast<int32_t>(
      JsonInt(JsonObject(attrs, "nb_steps"), "default",
              JsonInt(manifest, "nb_steps", 1)));
  double attr_g_timbre =
      JsonDouble(JsonObject(attrs, "guidance_timbre"), "default", 1.0);
  double attr_g_structure =
      JsonDouble(JsonObject(attrs, "guidance_structure"), "default", 1.0);
  const int max_steps = static_cast<int>(
      JsonInt(JsonObject(attrs, "nb_steps"), "max", 1));
  if (!codec_mode) {
    int attr0 = pcm_mode ? 2 : 6;
    if (argc > attr0) attr_nb_steps = std::atoi(argv[attr0]);
    if (argc > attr0 + 1) attr_g_timbre = std::atof(argv[attr0 + 1]);
    if (argc > attr0 + 2) attr_g_structure = std::atof(argv[attr0 + 2]);
  }
  auto clamp_steps = [&](int32_t v) {
    return std::min<int32_t>(std::max<int32_t>(v, 1), max_steps);
  };
  attr_nb_steps = clamp_steps(attr_nb_steps);

  // the stages' packages for this device (streaming/native.py)
  const auto stage_names = JsonStringList(manifest, "native_stages");
  const auto packages = JsonStringList(manifest, "native_" + device_name);
  const auto writes = JsonShapeList(manifest, "native_writes");
  if (stage_names.empty() || packages.size() != stage_names.size() ||
      writes.size() != stage_names.size())
    Die("the artifact has no native packages for " + device_name +
        ": package it with `after-tpu-torch export ... --native` (or "
        "streaming.native.package_artifact) on that device");
  const std::vector<std::string> needed =
      codec_mode ? std::vector<std::string>{"forward"}
      : midi_mode
          ? std::vector<std::string>{"piano_roll", "timbre", "step", "decode"}
          : std::vector<std::string>{"structure", "timbre", "step", "decode"};
  std::cerr << "[stream_host] loading "
            << (codec_mode ? "codec forward" : midi_mode ? "midi" : "a2a")
            << " stages on " << device_name << "...\n";
  auto t_load0 = std::chrono::steady_clock::now();
  std::map<std::string, Stage> stages;
  for (const auto& name : needed) {
    auto it = std::find(stage_names.begin(), stage_names.end(), name);
    if (it == stage_names.end())
      Die("the artifact's native packages have no stage " + name);
    const size_t k = it - stage_names.begin();
    Stage s;
    s.name = name;
    s.writes = writes[k];
    s.stateful = name != "piano_roll";
    // one runner, single-threaded: no event of its own, so that a CUDA
    // graph can capture it
    s.pkg = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
        art + "/" + packages[k], "model", /*run_single_threaded=*/true,
        /*num_runners=*/1, on_card ? 0 : -1);
    stages.emplace(name, std::move(s));
  }

#ifdef AFTER_TPU_TORCH_CUDA
  std::unique_ptr<c10::cuda::CUDAGuard> device_guard;
  std::unique_ptr<c10::cuda::CUDAStreamGuard> stream_guard;
  if (on_card) {
    device_guard = std::make_unique<c10::cuda::CUDAGuard>(device);
    // every upload, replay and readback runs on one stream of the host
    stream_guard = std::make_unique<c10::cuda::CUDAStreamGuard>(
        at::cuda::getStreamFromPool(false, 0));
    // the kernel's launch counters, made before any capture
    after_tpu_torch::device_counts(0);
  }
#endif

  // initial state -> device tensors, at fixed addresses from here on
  std::vector<at::Tensor> state(n_leaves);
  for (int64_t i = 0; i < n_leaves; ++i) {
    const std::string raw =
        ReadFile(art + "/state/leaf_" + std::to_string(i) + ".bin");
    at::Tensor t = at::empty(shapes[i], at::TensorOptions().dtype(
                                            DtypeOf(dtypes[i])));
    if (static_cast<size_t>(t.nbytes()) != raw.size())
      Die("state leaf " + std::to_string(i) + " has " +
          std::to_string(raw.size()) + " bytes, the manifest says " +
          std::to_string(t.nbytes()));
    std::memcpy(t.data_ptr(), raw.data(), raw.size());
    state[i] = t.to(device);
  }

  // the stages' inputs and outputs, at fixed addresses
  const int64_t B = n_voices;
  const std::string cfg = JsonObject(manifest, "config");
  const int64_t latent = JsonInt(JsonObject(cfg, "denoiser"), "n_channels",
                                 JsonInt(manifest, "z_channels", 0));
  at::Tensor audio_s = at::zeros({B, audio_chunk, 1}, f32);
  at::Tensor audio_t = at::zeros({B, audio_chunk, 1}, f32);
  at::Tensor y_out = at::zeros({B, audio_chunk, 1}, f32);
  at::Tensor tcond, zt, x, scalars, notes;
  std::vector<at::Tensor> slots;
  if (!codec_mode) {
    tcond = at::zeros({B, chunk, JsonInt(cfg, "zs_channels", 0)}, f32);
    zt = at::zeros({B, JsonInt(cfg, "zt_channels", 0)}, f32);
    x = at::zeros({B, chunk, latent}, f32);
    scalars = at::zeros({max_steps + 3}, f32);
    for (int i = 0; i < max_steps; ++i)
      slots.push_back(at::scalar_tensor(
          i, at::TensorOptions().dtype(at::kLong).device(device)));
    if (midi_mode) notes = at::zeros({B, chunk, n_poly, 2}, f32);
  }

  // a stage over the state and its inputs; its outputs 1.. into the state
  auto run = [&](Stage& s, std::vector<at::Tensor> inputs) -> at::Tensor {
    std::vector<at::Tensor> args;
    if (s.stateful) args = state;
    args.insert(args.end(), inputs.begin(), inputs.end());
    void* stream = nullptr;
#ifdef AFTER_TPU_TORCH_CUDA
    if (on_card) stream = at::cuda::getCurrentCUDAStream().stream();
#endif
    std::vector<at::Tensor> out = s.pkg->run(args, stream);
    if (out.size() != s.writes.size() + 1)
      Die("stage " + s.name + " returned " + std::to_string(out.size()) +
          " tensors, expected " + std::to_string(s.writes.size() + 1));
    for (size_t k = 0; k < s.writes.size(); ++k)
      state[s.writes[k]].copy_(out[k + 1]);
    return out[0];
  };
  // the calls of every stage, by key: a step by its KV slot
  std::vector<std::pair<std::string, std::function<void()>>> calls;
  if (codec_mode) {
    calls.emplace_back("forward", [&] {
      y_out.copy_(run(stages.at("forward"), {audio_s}));
    });
  } else {
    if (midi_mode)
      calls.emplace_back("piano_roll", [&] {
        tcond.copy_(run(stages.at("piano_roll"), {notes}));
      });
    else
      calls.emplace_back("structure", [&] {
        tcond.copy_(run(stages.at("structure"), {audio_s}));
      });
    calls.emplace_back("timbre", [&] {
      zt.copy_(run(stages.at("timbre"), {audio_t}));
    });
    for (int i = 0; i < max_steps; ++i)
      calls.emplace_back("step" + std::to_string(i), [&, i] {
        x.copy_(run(stages.at("step"), {x, zt, tcond, scalars, slots[i]}));
      });
    calls.emplace_back("decode", [&] {
      y_out.copy_(run(stages.at("decode"), {x}));
    });
  }
  std::map<std::string, size_t> call_index;
  for (size_t k = 0; k < calls.size(); ++k) call_index[calls[k].first] = k;

#ifdef AFTER_TPU_TORCH_CUDA
  // on the card: every stage run once (the state restored after), then
  // each captured as a CUDA graph in one pool, on a side stream
  std::vector<std::unique_ptr<at::cuda::CUDAGraph>> graphs;
  if (on_card) {
    auto side = at::cuda::getStreamFromPool(false, 0);
    at::cuda::CUDAEvent ready;
    ready.record(at::cuda::getCurrentCUDAStream());
    ready.block(side);
    {
      c10::cuda::CUDAStreamGuard g(side);
      std::vector<at::Tensor> saved;
      for (auto& t : state) saved.push_back(t.clone());
      for (auto& c : calls) c.second();
      for (size_t i = 0; i < state.size(); ++i) state[i].copy_(saved[i]);
    }
    c10::cuda::device_synchronize();
    const auto pool = at::cuda::graph_pool_handle();
    for (auto& c : calls) {
      auto graph = std::make_unique<at::cuda::CUDAGraph>();
      try {
        c10::cuda::CUDAStreamGuard g(side);
        graph->capture_begin(pool);
        c.second();
        graph->capture_end();
      } catch (const std::exception& e) {
        Die("stage " + c.first + " cannot be captured as a CUDA graph: " +
            e.what());
      }
      graphs.push_back(std::move(graph));
    }
    c10::cuda::device_synchronize();
  }
#endif
  auto play = [&](const std::string& key) {
    const size_t k = call_index.at(key);
#ifdef AFTER_TPU_TORCH_CUDA
    if (!graphs.empty()) {
      graphs[k]->replay();
      return;
    }
#endif
    calls[k].second();
  };
  const double load_s = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - t_load0).count();
  std::cerr << "[stream_host] load " << load_s << " s ("
            << stages.size() << " stage packages, "
#ifdef AFTER_TPU_TORCH_CUDA
            << graphs.size() << " CUDA graphs captured"
#else
            << "0 CUDA graphs captured"
#endif
            << ")\n";

  // the noise: --x0's buffers, or a generator seeded 0 on the device
  std::vector<float> x0_all;
  if (!x0_path.empty()) {
    const std::string raw = ReadFile(x0_path);
    x0_all.resize(raw.size() / 4);
    std::memcpy(x0_all.data(), raw.data(), x0_all.size() * 4);
  }
  at::Generator gen =
#ifdef AFTER_TPU_TORCH_CUDA
      on_card ? at::cuda::detail::createCUDAGenerator(0) :
#endif
              at::detail::createCPUGenerator(0);
  gen.set_current_seed(0);

  // host-side staging: pinned on the card, so that copies do not sync.
  // Each buffer stages into new tensors (``stage_inputs``): the caching
  // host allocator keeps a block until the copies that read it have run,
  // where one reused block would be overwritten by the next buffer while
  // this one's copy is still queued (readback depth 2 lets the host run a
  // buffer ahead of the card)
  const auto host_f32 = at::TensorOptions().dtype(at::kFloat).pinned_memory(
      on_card);
  at::Tensor h_s, h_t, h_x0, h_scalars, h_notes;
  float *hs = nullptr, *ht = nullptr;
  auto stage_inputs = [&] {
    h_s = at::empty({B, audio_chunk, 1}, host_f32);
    h_t = at::empty({B, audio_chunk, 1}, host_f32);
    hs = h_s.data_ptr<float>();
    ht = h_t.data_ptr<float>();
    if (!codec_mode) {
      h_x0 = at::empty({B, chunk, latent}, host_f32);
      h_scalars = at::empty({max_steps + 3}, host_f32);
    }
    if (midi_mode) h_notes = at::empty({B, chunk, n_poly, 2}, host_f32);
  };

  // out_all[v]: accumulated output samples for voice v (file mode)
  std::vector<std::vector<float>> out_all(n_voices);
  // per-phase accumulators
  double t_upload = 0, t_exec = 0, t_readback = 0;
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  std::vector<double> buffer_ms;

  // in-flight readback ring (AFTER_NATIVE_PIPELINE buffers deep, default 2:
  // the callback for buffer c emits buffer c-1, one buffer of latency)
  int64_t pipeline_depth = 2;
  if (const char* p = std::getenv("AFTER_NATIVE_PIPELINE"))
    pipeline_depth = std::max<int64_t>(1, std::atoi(p));
  struct Pending {
    at::Tensor host;  // the output, copied (asynchronously on the card)
#ifdef AFTER_TPU_TORCH_CUDA
    std::shared_ptr<at::cuda::CUDAEvent> done;
#endif
    std::chrono::steady_clock::time_point start;
  };
  std::deque<Pending> inflight;
  auto drain_one = [&] {
    Pending p = std::move(inflight.front());
    inflight.pop_front();
#ifdef AFTER_TPU_TORCH_CUDA
    if (p.done) p.done->synchronize();
#endif
    const float* data = p.host.data_ptr<float>();
    if (pcm_mode) {
      std::fwrite(data, 4, audio_chunk, stdout);
      std::fflush(stdout);
    } else {
      for (int64_t v = 0; v < n_voices; ++v)
        out_all[v].insert(out_all[v].end(), data + v * audio_chunk,
                          data + (v + 1) * audio_chunk);
    }
    buffer_ms.push_back(secs(p.start, now()) * 1e3);
  };

  // fills the host buffers for chunk c; false at end of input
  // pcm frames: 2ch interleaved (structure, timbre) for a2a; mono for codec
  int64_t pcm_ch = codec_mode ? 1 : 2;
  std::vector<float> pcm_frame(pcm_ch * audio_chunk);
  auto next_chunk = [&](int64_t c) -> bool {
    if (pcm_mode) {
      size_t got = std::fread(pcm_frame.data(), 4, pcm_frame.size(), stdin);
      if (got < pcm_frame.size()) {  // EOF
        if (got > 0)
          std::cerr << "[stream_host] dropping trailing partial buffer ("
                    << got / pcm_ch << " of " << audio_chunk
                    << " samples)\n";
        return false;
      }
      for (int64_t i = 0; i < audio_chunk; ++i) {
        hs[i] = pcm_frame[pcm_ch * i];
        if (!codec_mode) ht[i] = pcm_frame[2 * i + 1];
      }
      return true;
    }
    if (c >= n_chunks) return false;
    for (int64_t v = 0; v < n_voices; ++v) {
      if (midi_mode)
        std::memcpy(h_notes.data_ptr<float>() + v * chunk * n_poly * 2,
                    notes_all[v].data() + c * chunk * n_poly * 2,
                    chunk * n_poly * 2 * 4);
      else
        std::memcpy(hs + v * audio_chunk,
                    in_struct[v].samples.data() + c * audio_chunk,
                    audio_chunk * 4);
      if (!codec_mode)
        std::memcpy(ht + v * audio_chunk,
                    in_timbre[v].samples.data() + c * audio_chunk,
                    audio_chunk * 4);
    }
    return true;
  };

  if (pcm_mode)
    std::cerr << "[stream_host] live PCM mode: " << (codec_mode ? 1 : 2)
              << "ch f32 in, mono f32 out, "
              << audio_chunk << " samples/buffer\n";
  else
    std::cerr << "[stream_host] streaming " << n_chunks << " chunks of "
              << audio_chunk << " samples\n";

  // Live attribute control (the nn~ setter surface): AFTER_NATIVE_CTRL
  // names a FIFO/file polled non-blockingly between buffers for lines like
  //   nb_steps 4
  //   guidance_timbre 2.0
  //   @8 guidance_structure 1.5     (applies from buffer 8)
  // Each change applies from the next buffer (or buffer N), with no new
  // capture: the attributes reach the step graphs as device scalars.
  int ctrl_fd = -1;
  std::string ctrl_acc;
  std::deque<std::pair<int64_t, std::string>> ctrl_later;
  if (const char* p = std::getenv("AFTER_NATIVE_CTRL")) {
    ctrl_fd = open(p, O_RDONLY | O_NONBLOCK);
    if (ctrl_fd < 0)
      std::cerr << "[stream_host] WARNING: cannot open AFTER_NATIVE_CTRL "
                << p << " — live attribute control disabled\n";
    else if (codec_mode) {
      std::cerr << "[stream_host] WARNING: artifact has no runtime "
                   "attributes (codec-only) — AFTER_NATIVE_CTRL ignored\n";
      close(ctrl_fd);
      ctrl_fd = -1;
    }
  }
  auto apply_ctrl = [&](const std::string& line) {
    size_t sp = line.find(' ');
    if (sp == std::string::npos) return;
    std::string name = line.substr(0, sp), val = line.substr(sp + 1);
    if (name == "nb_steps") {
      attr_nb_steps = clamp_steps(std::atoi(val.c_str()));
    } else if (name == "guidance_timbre") {
      attr_g_timbre = std::atof(val.c_str());
    } else if (name == "guidance_structure") {
      attr_g_structure = std::atof(val.c_str());
    } else {
      std::cerr << "[stream_host] unknown attribute: " << name << "\n";
      return;
    }
    std::cerr << "[stream_host] set " << name << " = " << val << "\n";
  };
  auto poll_ctrl = [&](int64_t c) {
    if (ctrl_fd >= 0) {
      char tmp[256];
      ssize_t k;
      while ((k = read(ctrl_fd, tmp, sizeof(tmp))) > 0)
        ctrl_acc.append(tmp, k);
      size_t nl;
      while ((nl = ctrl_acc.find('\n')) != std::string::npos) {
        std::string line = ctrl_acc.substr(0, nl);
        ctrl_acc.erase(0, nl + 1);
        int64_t at_buffer = c;
        if (!line.empty() && line[0] == '@') {
          size_t sp = line.find(' ');
          if (sp == std::string::npos) continue;
          at_buffer = std::atoll(line.c_str() + 1);
          line = line.substr(sp + 1);
        }
        ctrl_later.emplace_back(at_buffer, line);
      }
    }
    for (auto it = ctrl_later.begin(); it != ctrl_later.end();) {
      if (it->first <= c) {
        apply_ctrl(it->second);
        it = ctrl_later.erase(it);
      } else {
        ++it;
      }
    }
  };

#ifdef AFTER_TPU_TORCH_CUDA
  if (on_card) after_tpu_torch::device_counts(0).zero_();
#endif
  const int64_t cpu_calls0 = after_tpu_torch::cpu_calls();
  auto t_stream0 = now();
  int64_t c = 0;
  for (; stage_inputs(), next_chunk(c); ++c) {
    poll_ctrl(c);
    Pending pend;
    pend.start = now();
    auto t0 = now();
    audio_s.copy_(h_s, /*non_blocking=*/on_card);
    if (!codec_mode) {
      if (midi_mode) notes.copy_(h_notes, on_card);
      audio_t.copy_(h_t, on_card);
    }
    auto t1 = now();
    int nb = 0;
    if (codec_mode) {
      play("forward");
    } else {
      play(midi_mode ? "piano_roll" : "structure");
      play("timbre");
      if (!x0_all.empty()) {
        const int64_t n = B * chunk * latent;
        if (static_cast<int64_t>(x0_all.size()) < (c + 1) * n)
          Die("--x0 holds " + std::to_string(x0_all.size() / n) +
              " buffers of noise, buffer " + std::to_string(c) +
              " needs one more");
        std::memcpy(h_x0.data_ptr<float>(), x0_all.data() + c * n, n * 4);
        x.copy_(h_x0, on_card);
      } else {
            x.normal_(0, 1, gen);
      }
      nb = StreamScalars(max_steps, attr_nb_steps, attr_g_timbre,
                         attr_g_structure, h_scalars.data_ptr<float>());
      scalars.copy_(h_scalars, on_card);
      for (int i = 0; i < nb; ++i) play("step" + std::to_string(i));
      play("decode");
    }
    // the output to the host: asynchronous on the card, awaited
    // pipeline_depth - 1 buffers later
    pend.host = at::empty({B, audio_chunk, 1}, host_f32);
    pend.host.copy_(y_out, on_card);
#ifdef AFTER_TPU_TORCH_CUDA
    if (on_card) {
      pend.done = std::make_shared<at::cuda::CUDAEvent>();
      pend.done->record();
    }
#endif
    auto t2 = now();
    t_upload += secs(t0, t1);
    t_exec += secs(t1, t2);
    inflight.push_back(std::move(pend));
    while (static_cast<int64_t>(inflight.size()) >= pipeline_depth) {
      auto t3 = now();
      drain_one();
      t_readback += secs(t3, now());
    }
  }
  while (!inflight.empty()) {
    auto t3 = now();
    drain_one();
    t_readback += secs(t3, now());
  }

  double stream_s = secs(t_stream0, now());
  if (!pcm_mode) {
    for (int64_t v = 0; v < n_voices; ++v) {
      WriteWav(out_paths[v], out_all[v], sr);
      std::cerr << "[stream_host] wrote " << out_all[v].size()
                << " samples -> " << out_paths[v] << "\n";
    }
  }
  if (c > 0) {
    std::cerr << "[stream_host] stream " << stream_s << " s total, "
              << (stream_s * 1e3 / c) << " ms/buffer ("
              << (double(audio_chunk) / sr * 1e3) << " ms audio/buffer)\n";
    std::cerr << "[stream_host] phases ms/buffer: upload "
              << (t_upload * 1e3 / c) << ", execute "
              << (t_exec * 1e3 / c) << ", readback "
              << (t_readback * 1e3 / c) << "\n";
    std::cerr << "[stream_host] buffer ms median / p90 / max: "
              << Median(buffer_ms, 0.5) << " / " << Median(buffer_ms, 0.9)
              << " / " << Median(buffer_ms, 1.0) << "\n";
    std::cerr << "[stream_host] buffer ms:";
    for (size_t i = 0; i < buffer_ms.size(); ++i)
      std::cerr << (i ? "," : " ") << buffer_ms[i];
    std::cerr << "\n";
  }
#ifdef AFTER_TPU_TORCH_CUDA
  if (on_card) {
    const at::Tensor n = after_tpu_torch::device_counts(0).cpu();
    std::cerr << "[stream_host] launches counted on the device: snake_conv "
              << n[0].item<int64_t>() << ", sum_splits "
              << n[1].item<int64_t>() << " in " << c << " buffers\n";
    std::cerr << "[stream_host] bf16 launches counted on the device: "
                 "snake_conv "
              << n[2].item<int64_t>() << ", sum_splits "
              << n[3].item<int64_t>() << " in " << c << " buffers\n";
  }
#endif
  if (!on_card)
    std::cerr << "[stream_host] snake_conv plain-version calls on the CPU: "
              << after_tpu_torch::cpu_calls() - cpu_calls0 << " in " << c
              << " buffers\n";
  return 0;
}
