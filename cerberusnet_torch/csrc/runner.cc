// cerberus_runner: runs an exported program of the PyTorch port in a
// process without Python, the counterpart of native/pjrt_runner (the JAX
// package's runner of its StableHLO artifact) and of the reference's
// TensorRT engine runner.
//
// The artifact is a directory that export/aot.py writes (model.pt2 and
// manifest.json) and that export/aot.py package_for_runner compiles ahead
// of time with AOTInductor into model_aoti.pt2. This program loads that
// package with torch::inductor::AOTIModelPackageLoader, feeds it raw
// tensors, PNGs or a stream of serve requests, and reports timing. The
// hand kernels inside the program are the cerberus:: operators, which
// resolve through the dispatcher to the C++ operator library
// (cerberus_ops.cc) that --ops loads; an operator the process lacks fails
// the load, naming it.
//
// Usage:
//   cerberus_runner --model <export_dir> [--device cuda|cpu] [--iters 10]
//                   [--ops libcerberus_ops.so] [--inputs a.bin,b.bin,...]
//                   [--pngs a.png,...] [--dump-outputs DIR] [--serve]
//
// --device: cuda unless asked for; cuda is refused when torch finds no
//   device, and a package compiled for another platform (the manifest's
//   "platforms") is refused. The runner never falls back to the CPU.
// --inputs: raw little-endian tensor files, the manifest's input shapes and
//   dtypes byte for byte (export/runner_io.py write_bin); without it the
//   inputs are zero-filled.
// --pngs: PNG files decoded and normalised by the data pipeline's native
//   decoder (native/dataload/png_decode.cc, compiled in: (x/255 - mean) /
//   std in float32, then round-to-nearest-even to the manifest dtype). One
//   file per (1, H, W, 3) input, or K files into the stacked signature's one
//   (K, H, W, 3) input. Images must have the exported (H, W).
// --dump-outputs: the last call's outputs as DIR/output_<i>.bin and
//   DIR/outputs.json ({file, dtype, shape} per output).
// --ops: the operator library, loaded with dlopen before the package.
// --serve: a warm process answering framed requests on stdin/stdout. It
//   prints "READY <n_in> <n_out>", then reads requests until EOF:
//     "INFER\n" + the raw bytes of every manifest input in order, or
//     "PNGS p1,p2,...\n" (decoded here), or
//     "QUIT\n" (exit 0).
//   Each answer is "OK <n_out>\n", then for each output
//   "OUT <dtype> <ndims> <d0> ... <nbytes>\n" and its raw bytes. A bad
//   request prints "ERR <msg>\n" and exits 1.
//
// Without --serve the last stdout line is JSON: {"load_ms", "avg_exec_ms",
// "iters", "calls", "num_outputs", "launches": {operator: count}}; calls
// counts the warm-up call too, launches the operator library's counters
// over every call. Each timed call ends in a synchronisation of the
// device's stream. TF32 is off for cuDNN and cuBLAS, as in the Python
// processes that hold the runner's outputs. The reference runner's
// --plugin, --opt and --cache have no counterpart: the package is compiled
// ahead of time, so the runner never compiles and a cache would hold
// nothing.

#include <dlfcn.h>
#include <sys/stat.h>

#include <ATen/ATen.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

// native PNG decode and normalisation (native/dataload/png_decode.cc):
// dtype_code 0 float32, 1 bfloat16
extern "C" int cnt_png_to_input(const char* path, uint32_t want_h,
                                uint32_t want_w, int dtype_code, void* out);
extern "C" const char* cnt_png_error(int code);

namespace {

// the operators whose launches the runner reports
const char* const kOperators[] = {"corr2d_fwd", "corr1d_fwd",
                                  "encoder_level_fwd"};

struct Spec {
  std::vector<int64_t> dims;
  std::string dtype;
};

struct Manifest {
  std::vector<std::string> platforms;
  std::vector<Spec> inputs, outputs;
};

[[noreturn]] void Die(const std::string& msg) {
  std::fprintf(stderr, "cerberus_runner: %s\n", msg.c_str());
  std::exit(1);
}

// An exception's message; torch's errors without their backtrace.
std::string Message(const std::exception& e) {
  if (const auto* err = dynamic_cast<const c10::Error*>(&e))
    return err->what_without_backtrace();
  return e.what();
}

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Die("cannot read " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

std::vector<std::string> Split(const std::string& s, char sep) {
  std::vector<std::string> out;
  std::stringstream ss(s);
  std::string tok;
  while (std::getline(ss, tok, sep))
    if (!tok.empty()) out.push_back(tok);
  return out;
}

// The strings of a JSON array of strings starting at json[pos] ('[').
std::vector<std::string> StringArray(const std::string& json, size_t pos) {
  std::vector<std::string> out;
  const size_t end = json.find(']', pos);
  while (true) {
    const size_t q1 = json.find('"', pos);
    if (q1 == std::string::npos || q1 > end) break;
    const size_t q2 = json.find('"', q1 + 1);
    out.push_back(json.substr(q1 + 1, q2 - q1 - 1));
    pos = q2 + 1;
  }
  return out;
}

// The {"shape": [...], "dtype": "..."} objects of the array under key.
std::vector<Spec> Specs(const std::string& json, const std::string& key) {
  std::vector<Spec> specs;
  const size_t start = json.find("\"" + key + "\"");
  if (start == std::string::npos) Die("manifest has no \"" + key + "\"");
  // the array ends at the first "]" that closes it (shapes are flat)
  size_t pos = json.find('[', start);
  int depth = 0;
  size_t end = pos;
  for (; end < json.size(); ++end) {
    if (json[end] == '[') ++depth;
    if (json[end] == ']' && --depth == 0) break;
  }
  while (true) {
    const size_t sh = json.find("\"shape\"", pos);
    if (sh == std::string::npos || sh > end) break;
    const size_t lb = json.find('[', sh), rb = json.find(']', lb);
    Spec s;
    for (const std::string& tok : Split(json.substr(lb + 1, rb - lb - 1), ','))
      s.dims.push_back(std::stoll(tok));
    const size_t dt = json.find("\"dtype\"", sh);
    const size_t q1 = json.find('"', json.find(':', dt));
    const size_t q2 = json.find('"', q1 + 1);
    s.dtype = json.substr(q1 + 1, q2 - q1 - 1);
    specs.push_back(s);
    pos = rb + 1;
  }
  if (specs.empty()) Die("manifest lists no " + key);
  return specs;
}

// The manifest export/aot.py writes (its schema, not a general parser).
Manifest ReadManifest(const std::string& dir) {
  const std::string json = ReadFile(dir + "/manifest.json");
  Manifest m;
  const size_t p = json.find("\"platforms\"");
  if (p == std::string::npos) Die("manifest has no \"platforms\"");
  m.platforms = StringArray(json, json.find('[', p));
  m.inputs = Specs(json, "inputs");
  m.outputs = Specs(json, "outputs");
  return m;
}

at::ScalarType ScalarType(const std::string& dtype) {
  if (dtype == "float32") return at::kFloat;
  if (dtype == "bfloat16") return at::kBFloat16;
  if (dtype == "float16") return at::kHalf;
  if (dtype == "int32") return at::kInt;
  if (dtype == "uint8") return at::kByte;
  Die("unsupported dtype " + dtype);
}

std::string DtypeName(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return "float32";
    case at::kBFloat16: return "bfloat16";
    case at::kHalf: return "float16";
    case at::kInt: return "int32";
    case at::kByte: return "uint8";
    default: return "unknown";
  }
}

size_t Bytes(const Spec& s) {
  size_t n = at::elementSize(ScalarType(s.dtype));
  for (int64_t d : s.dims) n *= static_cast<size_t>(d);
  return n;
}

// A host tensor of the spec's shape and type.
at::Tensor HostTensor(const Spec& s) {
  return at::empty(s.dims, at::TensorOptions().dtype(ScalarType(s.dtype)));
}

void CheckPngDtype(const Spec& s) {
  if (s.dtype != "float32" && s.dtype != "bfloat16")
    throw std::runtime_error(
        "PNG inputs take float32 or bfloat16, the manifest says " + s.dtype);
}

// Decodes one exact-size PNG into frame `index` of the host tensor t
// (K, H, W, 3).
void DecodePng(const std::string& path, at::Tensor& t, int64_t index) {
  const int64_t h = t.size(1), w = t.size(2);
  char* base = static_cast<char*>(t.data_ptr()) +
               index * h * w * 3 * t.element_size();
  const int rc = cnt_png_to_input(path.c_str(), uint32_t(h), uint32_t(w),
                                  t.scalar_type() == at::kBFloat16, base);
  if (rc != 0)
    throw std::runtime_error(path + ": " + cnt_png_error(rc) +
                             " (an 8-bit PNG of exactly " + std::to_string(h) +
                             "x" + std::to_string(w) +
                             " is needed: the package is fixed-shape)");
}

// True when the manifest declares the producer-stacked signature: one
// (K, H, W, 3) input taking K decoded frames.
bool IsStackedPngSignature(const std::vector<Spec>& in, size_t num_pngs) {
  return in.size() == 1 && in[0].dims.size() == 4 && in[0].dims[3] == 3 &&
         num_pngs > 1 && in[0].dims[0] == static_cast<int64_t>(num_pngs);
}

// The host tensors of the inputs from PNG files.
std::vector<at::Tensor> PngInputs(const std::vector<std::string>& paths,
                                  const std::vector<Spec>& in) {
  std::vector<at::Tensor> out;
  if (IsStackedPngSignature(in, paths.size())) {
    CheckPngDtype(in[0]);
    at::Tensor t = HostTensor(in[0]);
    for (size_t i = 0; i < paths.size(); ++i) DecodePng(paths[i], t, i);
    out.push_back(t);
    return out;
  }
  if (paths.size() != in.size())
    throw std::runtime_error("PNG count " + std::to_string(paths.size()) +
                             " != manifest input count " +
                             std::to_string(in.size()));
  for (size_t i = 0; i < in.size(); ++i) {
    if (in[i].dims.size() != 4 || in[i].dims[0] != 1 || in[i].dims[3] != 3)
      throw std::runtime_error("PNG inputs need (1, H, W, 3) image inputs");
    CheckPngDtype(in[i]);
    at::Tensor t = HostTensor(in[i]);
    DecodePng(paths[i], t, 0);
    out.push_back(t);
  }
  return out;
}

class Runner {
 public:
  Runner(const std::string& dir, const at::Device& device)
      : device_(device), loader_(dir + "/model_aoti.pt2") {}

  // One call on host or device tensors; outputs on the device.
  std::vector<at::Tensor> Call(const std::vector<at::Tensor>& inputs) {
    std::vector<at::Tensor> in;
    for (const at::Tensor& t : inputs) in.push_back(t.to(device_));
    return loader_.run(in);
  }

  // Waits for the device's current stream (a CPU call has returned done).
  void Synchronize() {
    if (!device_.is_cuda()) return;
    c10::impl::VirtualGuardImpl impl(device_.type());
    impl.synchronizeStream(impl.getStream(device_));
  }

 private:
  at::Device device_;
  torch::inductor::AOTIModelPackageLoader loader_;
};

at::Tensor Dense(const at::Tensor& t) {
  return t.to(at::kCPU).contiguous();
}

// The --serve loop (see the usage comment at the top of the file).
[[noreturn]] void Serve(Runner& runner, const Manifest& m) {
  auto err = [](const std::string& msg) {
    std::printf("ERR %s\n", msg.c_str());
    std::fflush(stdout);
    std::exit(1);
  };
  std::printf("READY %zu %zu\n", m.inputs.size(), m.outputs.size());
  std::fflush(stdout);
  std::string line;
  size_t requests = 0;
  while (std::getline(std::cin, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line.empty()) continue;
    if (line == "QUIT") break;
    std::vector<at::Tensor> inputs;
    try {
      if (line == "INFER") {
        for (const Spec& s : m.inputs) {
          at::Tensor t = HostTensor(s);
          const size_t n = Bytes(s);
          std::cin.read(static_cast<char*>(t.data_ptr()),
                        static_cast<std::streamsize>(n));
          if (static_cast<size_t>(std::cin.gcount()) != n)
            err("short read: expected " + std::to_string(n) + " bytes");
          inputs.push_back(t);
        }
      } else if (line.rfind("PNGS ", 0) == 0) {
        inputs = PngInputs(Split(line.substr(5), ','), m.inputs);
      } else {
        err("unknown request '" + line + "'");
      }
      std::vector<at::Tensor> outputs = runner.Call(inputs);
      std::printf("OK %zu\n", outputs.size());
      for (const at::Tensor& o : outputs) {
        const at::Tensor host = Dense(o);
        std::printf("OUT %s %lld", DtypeName(host.scalar_type()).c_str(),
                    static_cast<long long>(host.dim()));
        for (int64_t d : host.sizes()) std::printf(" %lld", (long long)d);
        std::printf(" %zu\n", host.nbytes());
        std::fwrite(host.data_ptr(), 1, host.nbytes(), stdout);
      }
      std::fflush(stdout);
    } catch (const std::exception& e) {
      // the first line of the message: the protocol's line is one line
      const std::string what = Message(e);
      err(what.substr(0, what.find('\n')));
    }
    ++requests;
  }
  std::fprintf(stderr, "cerberus_runner: serve: %zu request(s) handled\n",
               requests);
  std::exit(0);
}

void Dump(const std::string& dir, const std::vector<at::Tensor>& outputs) {
  mkdir(dir.c_str(), 0755);
  std::ostringstream meta;
  meta << "[";
  for (size_t i = 0; i < outputs.size(); ++i) {
    const at::Tensor host = Dense(outputs[i]);
    const std::string file = "output_" + std::to_string(i) + ".bin";
    std::ofstream f(dir + "/" + file, std::ios::binary);
    if (!f) Die("cannot write " + dir + "/" + file);
    f.write(static_cast<const char*>(host.data_ptr()),
            static_cast<std::streamsize>(host.nbytes()));
    if (i) meta << ", ";
    meta << "{\"file\": \"" << file << "\", \"dtype\": \""
         << DtypeName(host.scalar_type()) << "\", \"shape\": [";
    for (int64_t d = 0; d < host.dim(); ++d)
      meta << (d ? ", " : "") << host.size(d);
    meta << "]}";
  }
  meta << "]";
  std::ofstream(dir + "/outputs.json") << meta.str() << "\n";
}

}  // namespace

int main(int argc, char** argv) {
  std::string model_dir, device_arg = "cuda", ops_path, inputs_arg, pngs_arg,
              dump_dir;
  bool serve = false;
  int iters = 10;
  for (int i = 1; i < argc; ++i) {
    const std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) Die("missing value after " + a);
      return argv[++i];
    };
    if (a == "--model") model_dir = next();
    else if (a == "--device") device_arg = next();
    else if (a == "--iters") iters = std::stoi(next());
    else if (a == "--ops") ops_path = next();
    else if (a == "--inputs") inputs_arg = next();
    else if (a == "--pngs") pngs_arg = next();
    else if (a == "--dump-outputs") dump_dir = next();
    else if (a == "--serve") serve = true;
    else Die("unknown flag " + a);
  }
  if (model_dir.empty() || iters < 1)
    Die("usage: cerberus_runner --model <export_dir> [--device cuda|cpu] "
        "[--iters N] [--ops libcerberus_ops.so] [--inputs a.bin,...] "
        "[--pngs a.png,...] [--dump-outputs DIR] [--serve]");
  if (!inputs_arg.empty() && !pngs_arg.empty())
    Die("--inputs and --pngs are exclusive");
  if (device_arg != "cuda" && device_arg != "cpu")
    Die("--device takes cuda or cpu, got " + device_arg);
  if (device_arg == "cuda" && !at::hasCUDA())
    Die("--device cuda: torch finds no CUDA device here (the runner never "
        "falls back to the CPU)");
  const Manifest manifest = ReadManifest(model_dir);
  bool platform_ok = false;
  std::string platforms;
  for (const std::string& p : manifest.platforms) {
    platform_ok |= p == device_arg;
    platforms += (platforms.empty() ? "" : ", ") + p;
  }
  if (!platform_ok)
    Die("the package was compiled for [" + platforms + "], not " +
        device_arg + " (manifest.json \"platforms\")");

  void* ops = nullptr;
  if (!ops_path.empty()) {
    ops = dlopen(ops_path.c_str(), RTLD_NOW | RTLD_LOCAL);
    if (!ops) Die(std::string("dlopen of the operator library failed: ") +
                  dlerror());
  }
  using LaunchesFn = int64_t (*)(const char*);
  const auto launches = ops ? reinterpret_cast<LaunchesFn>(
                                  dlsym(ops, "cerberus_ops_launches"))
                            : nullptr;
  if (ops && !launches) Die(ops_path + " has no cerberus_ops_launches");

  // float32 convolutions and products in full float32
  at::globalContext().setAllowTF32CuDNN(false);
  at::globalContext().setAllowTF32CuBLAS(false);
  c10::InferenceMode inference;
  const at::Device device(device_arg == "cuda" ? at::kCUDA : at::kCPU,
                          device_arg == "cuda" ? 0 : -1);

  const auto t_load = std::chrono::steady_clock::now();
  std::unique_ptr<Runner> runner;
  try {
    runner = std::make_unique<Runner>(model_dir, device);
  } catch (const std::exception& e) {
    Die("loading " + model_dir + "/model_aoti.pt2 failed: " + Message(e));
  }
  const double load_ms = std::chrono::duration<double, std::milli>(
                             std::chrono::steady_clock::now() - t_load)
                             .count();
  if (serve) {
    std::fprintf(stderr, "cerberus_runner: serving (load %.1f ms)\n", load_ms);
    Serve(*runner, manifest);
  }

  std::vector<at::Tensor> inputs;
  try {
    if (!pngs_arg.empty()) {
      inputs = PngInputs(Split(pngs_arg, ','), manifest.inputs);
    } else {
      const std::vector<std::string> files = Split(inputs_arg, ',');
      if (!files.empty() && files.size() != manifest.inputs.size())
        Die("--inputs count != manifest input count");
      for (size_t i = 0; i < manifest.inputs.size(); ++i) {
        const Spec& s = manifest.inputs[i];
        at::Tensor t = HostTensor(s);
        if (files.empty()) {
          t.zero_();
        } else {
          const std::string raw = ReadFile(files[i]);
          if (raw.size() != Bytes(s))
            Die("input " + files[i] + " has " + std::to_string(raw.size()) +
                " bytes, expected " + std::to_string(Bytes(s)));
          std::memcpy(t.data_ptr(), raw.data(), raw.size());
        }
        inputs.push_back(t);
      }
    }
    for (at::Tensor& t : inputs) t = t.to(device);
  } catch (const std::exception& e) {
    Die(Message(e));
  }

  std::vector<at::Tensor> outputs;
  double total_ms = 0.0;
  try {
    for (int it = 0; it < iters + 1; ++it) {  // the first call warms up
      const auto t0 = std::chrono::steady_clock::now();
      outputs = runner->Call(inputs);
      runner->Synchronize();
      const double ms = std::chrono::duration<double, std::milli>(
                            std::chrono::steady_clock::now() - t0)
                            .count();
      if (it > 0) total_ms += ms;
    }
  } catch (const std::exception& e) {
    Die("running the package failed: " + Message(e));
  }
  if (!dump_dir.empty()) Dump(dump_dir, outputs);

  std::string counts;
  for (const char* name : kOperators) {
    if (!launches) break;
    counts += std::string(counts.empty() ? "" : ", ") + "\"" + name +
              "\": " + std::to_string(launches(name));
  }
  std::printf(
      "{\"load_ms\": %.3f, \"avg_exec_ms\": %.3f, \"iters\": %d, "
      "\"calls\": %d, \"num_outputs\": %zu, \"launches\": {%s}}\n",
      load_ms, total_ms / iters, iters, iters + 1, outputs.size(),
      counts.c_str());
  return 0;
}
