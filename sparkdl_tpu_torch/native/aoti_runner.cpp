// aoti_runner — a C ABI over AOTInductor's model package loader.
//
// The port's counterpart of sparkdl_tpu/native/pjrt_runner.cpp: where that
// runner compiled StableHLO on a PJRT plugin, this one loads a package that
// `torch._inductor.aoti_compile_and_package` compiled ahead of time
// (`program.pt2`, written by sparkdl_tpu_torch/native/aoti.py's
// export_program) and runs it from C++, with no Python in the call.
//
// A program directory holds:
//   program.pt2    the AOTInductor package; the parameters are its leading
//                  inputs, then the data inputs
//   params.bin     the parameter leaves' raw bytes, back to back
//   manifest.txt   `device <cpu|cuda>`, then one line a tensor:
//                  `<param|input|output> <dtype> <d0,d1,...|scalar>`
//
// aoti_runner_create loads the package onto the device asked for (it
// refuses a package compiled for another device type), reads params.bin
// once into tensors that stay resident on that device, and on the card
// takes a stream of its own. A batch goes in by aoti_runner_put (or
// _put_async) from a host or a device pointer into a buffer the runner
// holds; aoti_runner_execute runs the package over the resident parameters
// and the given buffers, and its outputs are buffers too, copied into the
// caller's memory by aoti_runner_get and released by aoti_runner_free_buffer.
// aoti_runner_live_buffers counts the buffers held, so a caller can see
// that nothing leaks.
//
// The runner is device-generic: the stream, the events and the guards are
// c10's (the card's implementation comes from libc10_cuda, which the
// build links), so one source builds for the CPU and for the card and
// includes no CUDA header. Every entry point catches what the loader or
// ATen throws (a c10::Error among them); the message becomes
// aoti_runner_last_error and the call returns a negative value. Nothing
// throws across the ABI. Calls on one runner are serialised by its mutex.
//
// Built at first use by sparkdl_tpu_torch/native/aoti.py:
//   g++ -O2 -std=c++17 -fPIC -shared -D_GLIBCXX_USE_CXX11_ABI=<torch's>
//       -I<torch includes> aoti_runner.cpp -L<torch/lib> -Wl,-rpath,...
//       -ltorch -ltorch_cpu -lc10 [-ltorch_cuda -lc10_cuda]

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/from_blob.h>
#include <c10/core/Event.h>
#include <c10/core/Stream.h>
#include <c10/core/StreamGuard.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <cstdint>
#include <cstdio>
#include <exception>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <optional>
#include <sstream>
#include <string>
#include <vector>

namespace {

constexpr int32_t kAbiVersion = 1;

struct Spec {
  std::string dtype;  // short name: f32, bf16, u8, ...
  at::ScalarType type;
  std::vector<int64_t> dims;
  int64_t bytes = 0;
};

at::ScalarType scalar_type(const std::string& name) {
  if (name == "f32") return at::kFloat;
  if (name == "f64") return at::kDouble;
  if (name == "f16") return at::kHalf;
  if (name == "bf16") return at::kBFloat16;
  if (name == "u8") return at::kByte;
  if (name == "s8") return at::kChar;
  if (name == "s16") return at::kShort;
  if (name == "s32") return at::kInt;
  if (name == "s64") return at::kLong;
  if (name == "pred") return at::kBool;
  throw std::runtime_error("unsupported dtype in manifest: " + name);
}

struct Buffer {
  at::Tensor tensor;
  // recorded on the runner's stream after the work that defines the
  // buffer (its copy in, or the run that produced it); none on the CPU
  std::shared_ptr<c10::Event> ready;
};

}  // namespace

struct AotiRunner {
  std::mutex mu;
  std::string last_error;
  c10::Device device{c10::kCPU};
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  std::vector<Spec> params, inputs, outputs;
  std::vector<at::Tensor> resident;
  std::map<int64_t, Buffer> buffers;
  std::map<void*, at::Tensor> host_buffers;  // aoti_runner_alloc_host's
  int64_t next_id = 1;
  // on the card: the runner's stream for copies in and runs, and a second
  // one for copies out, so fetching batch i overlaps the run of batch i+1
  std::optional<c10::Stream> stream, fetch_stream;

  bool on_card() const { return device.type() != c10::kCPU; }
};

namespace {

void fill_error(char* err, int32_t len, const std::string& msg) {
  if (err && len > 0) std::snprintf(err, static_cast<size_t>(len), "%s", msg.c_str());
}

// Runs `body` under the runner's lock; an exception becomes last_error and
// `failure` is returned.
template <typename T, typename F>
T guarded(AotiRunner* r, T failure, F&& body) {
  if (r == nullptr) return failure;
  std::lock_guard<std::mutex> lock(r->mu);
  try {
    r->last_error.clear();
    return body();
  } catch (const c10::Error& e) {
    r->last_error = e.what_without_backtrace();
  } catch (const std::exception& e) {
    r->last_error = e.what();
  } catch (...) {
    r->last_error = "unknown error";
  }
  return failure;
}

// Reads `dir`/manifest.txt into the runner's specs; returns the device
// type the package was compiled for.
std::string read_manifest(AotiRunner* r, const std::string& dir) {
  std::ifstream mf(dir + "/manifest.txt");
  if (!mf) throw std::runtime_error("cannot open " + dir + "/manifest.txt");
  std::string device, line;
  while (std::getline(mf, line)) {
    std::istringstream ls(line);
    std::string kind, dtype, dims;
    if (!(ls >> kind >> dtype)) continue;
    if (kind == "device") {
      device = dtype;
      continue;
    }
    if (!(ls >> dims) || (kind != "param" && kind != "input" && kind != "output"))
      throw std::runtime_error("malformed manifest line: " + line);
    Spec s;
    s.dtype = dtype;
    s.type = scalar_type(dtype);
    if (dims != "scalar") {
      std::istringstream ds(dims);
      std::string tok;
      while (std::getline(ds, tok, ',')) s.dims.push_back(std::stoll(tok));
    }
    s.bytes = static_cast<int64_t>(c10::elementSize(s.type));
    for (int64_t d : s.dims) s.bytes *= d;
    (kind == "param" ? r->params : kind == "input" ? r->inputs : r->outputs)
        .push_back(std::move(s));
  }
  return device;
}

std::string shape_str(const std::vector<int64_t>& dims) {
  std::string out = "(";
  for (size_t i = 0; i < dims.size(); ++i) out += (i ? ", " : "") + std::to_string(dims[i]);
  return out + ")";
}

// The current stream of the runner's device: where a caller's device
// tensors were made.
c10::Stream current_stream(const AotiRunner* r) {
  return c10::impl::VirtualGuardImpl(r->device.type()).getStream(r->device);
}

std::shared_ptr<c10::Event> record(const c10::Stream& stream) {
  auto ev = std::make_shared<c10::Event>(stream.device_type());
  ev->record(stream);
  return ev;
}

const Buffer& buffer(AotiRunner* r, int64_t id) {
  auto it = r->buffers.find(id);
  if (it == r->buffers.end()) throw std::runtime_error("no buffer " + std::to_string(id));
  return it->second;
}

// A buffer holding input `index`'s bytes from `data` (a host pointer, or a
// device pointer where `on_device`). On the card the copy is enqueued on
// the runner's stream, after the caller's current stream's work so far
// (which made a device source); `wait` then blocks until it has completed.
int64_t put(AotiRunner* r, int32_t index, const void* data, int32_t on_device, bool wait) {
  if (index < 0 || index >= static_cast<int32_t>(r->inputs.size()))
    throw std::runtime_error("no input " + std::to_string(index));
  if (data == nullptr) throw std::runtime_error("null input pointer");
  const Spec& s = r->inputs[index];
  auto where = on_device ? r->device : c10::Device(c10::kCPU);
  at::Tensor src = at::from_blob(const_cast<void*>(data), s.dims,
                                 at::TensorOptions().dtype(s.type).device(where));
  Buffer b;
  if (!r->on_card()) {
    b.tensor = src.clone();
  } else {
    if (on_device) record(current_stream(r))->block(*r->stream);
    c10::StreamGuard guard(*r->stream);
    b.tensor = at::empty(s.dims, at::TensorOptions().dtype(s.type).device(r->device));
    b.tensor.copy_(src, /*non_blocking=*/true);
    b.ready = record(*r->stream);
    if (wait) b.ready->synchronize();
  }
  int64_t id = r->next_id++;
  r->buffers.emplace(id, std::move(b));
  return id;
}

// Runs the package over the resident parameters and the buffers `ids`;
// writes the outputs' buffer ids to `out_ids` and returns their count.
int32_t execute(AotiRunner* r, const int64_t* ids, int32_t n, int64_t* out_ids, bool wait) {
  if (n != static_cast<int32_t>(r->inputs.size()))
    throw std::runtime_error("the program takes " + std::to_string(r->inputs.size()) +
                             " inputs, got " + std::to_string(n));
  std::vector<at::Tensor> args(r->resident);
  for (int32_t i = 0; i < n; ++i) args.push_back(buffer(r, ids[i]).tensor);
  std::vector<at::Tensor> outs;
  std::shared_ptr<c10::Event> done;
  if (!r->on_card()) {
    outs = r->loader->run(args);
  } else {
    c10::StreamGuard guard(*r->stream);
    outs = r->loader->run(args, r->stream->native_handle());
    done = record(*r->stream);
    if (wait) done->synchronize();
  }
  if (outs.size() != r->outputs.size())
    throw std::runtime_error("the package gave " + std::to_string(outs.size()) +
                             " outputs, the manifest names " +
                             std::to_string(r->outputs.size()));
  for (size_t i = 0; i < outs.size(); ++i) {
    int64_t id = r->next_id++;
    r->buffers.emplace(id, Buffer{outs[i], done});
    out_ids[i] = id;
  }
  return static_cast<int32_t>(outs.size());
}

}  // namespace

extern "C" {

int32_t aoti_abi_version() { return kAbiVersion; }

AotiRunner* aoti_runner_create(const char* program_dir, const char* device, char* err,
                               int32_t err_len) {
  auto r = std::make_unique<AotiRunner>();
  try {
    const std::string dir = program_dir ? program_dir : "";
    r->device = c10::Device(std::string(device ? device : "cpu"));
    const std::string made_for = read_manifest(r.get(), dir);
    const std::string asked = c10::DeviceTypeName(r->device.type(), /*lower_case=*/true);
    if (made_for != asked)
      throw std::runtime_error("the program in " + dir + " was compiled for '" + made_for +
                               "'; a package runs only on that device type, and this "
                               "runner was asked for '" + asked + "'");
    if (r->on_card() && !r->device.has_index()) r->device.set_index(0);
    std::optional<c10::DeviceGuard> device_guard;
    if (r->on_card()) {
      device_guard.emplace(r->device);
      c10::impl::VirtualGuardImpl impl(r->device.type());
      r->stream = impl.getStreamFromGlobalPool(r->device, /*isHighPriority=*/false);
      r->fetch_stream = impl.getStreamFromGlobalPool(r->device, false);
    }
    r->loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(dir + "/program.pt2");

    std::ifstream pf(dir + "/params.bin", std::ios::binary | std::ios::ate);
    if (!pf) throw std::runtime_error("cannot open " + dir + "/params.bin");
    int64_t total = 0;
    for (const Spec& s : r->params) total += s.bytes;
    const int64_t size = static_cast<int64_t>(pf.tellg());
    if (size != total)
      throw std::runtime_error("params.bin holds " + std::to_string(size) +
                               " bytes; the manifest's parameters take " +
                               std::to_string(total));
    pf.seekg(0);
    at::Tensor host = at::empty({total}, at::TensorOptions().dtype(at::kByte));
    if (total && !pf.read(reinterpret_cast<char*>(host.data_ptr()), total))
      throw std::runtime_error("short read of params.bin");
    int64_t off = 0;
    for (const Spec& s : r->params) {
      at::Tensor leaf = at::from_blob(static_cast<uint8_t*>(host.data_ptr()) + off, s.dims,
                                      at::TensorOptions().dtype(s.type));
      r->resident.push_back(leaf.to(r->device, /*non_blocking=*/false, /*copy=*/true));
      off += s.bytes;
    }
    return r.release();
  } catch (const c10::Error& e) {
    fill_error(err, err_len, e.what_without_backtrace());
  } catch (const std::exception& e) {
    fill_error(err, err_len, e.what());
  } catch (...) {
    fill_error(err, err_len, "unknown error");
  }
  return nullptr;
}

const char* aoti_runner_last_error(AotiRunner* r) {
  return r ? r->last_error.c_str() : "no runner";
}

// Copies input `index`'s bytes in and waits for the copy.
int64_t aoti_runner_put(AotiRunner* r, int32_t index, const void* data, int32_t on_device) {
  return guarded<int64_t>(r, -1, [&] { return put(r, index, data, on_device, true); });
}

// Enqueues the copy and returns: `data` must stay unchanged until
// aoti_runner_await_buffer on the id returns, or until an output of a run
// that read it has been fetched.
int64_t aoti_runner_put_async(AotiRunner* r, int32_t index, const void* data,
                              int32_t on_device) {
  return guarded<int64_t>(r, -1, [&] { return put(r, index, data, on_device, false); });
}

// Blocks until the work that defines buffer `id` has completed.
int32_t aoti_runner_await_buffer(AotiRunner* r, int64_t id) {
  return guarded<int32_t>(r, -1, [&] {
    const Buffer& b = buffer(r, id);
    if (b.ready) b.ready->synchronize();
    return 0;
  });
}

// Runs the package over buffers `ids` (the data inputs, in order) and waits;
// returns the number of output buffers written to `out_ids`.
int32_t aoti_runner_execute(AotiRunner* r, const int64_t* ids, int32_t n, int64_t* out_ids) {
  return guarded<int32_t>(r, -1, [&] { return execute(r, ids, n, out_ids, true); });
}

// As aoti_runner_execute, but returns once the run is enqueued.
int32_t aoti_runner_execute_async(AotiRunner* r, const int64_t* ids, int32_t n,
                                  int64_t* out_ids) {
  return guarded<int32_t>(r, -1, [&] { return execute(r, ids, n, out_ids, false); });
}

// Copies buffer `id` into `dst` (host memory, or device memory where
// `on_device`), which holds `nbytes`, once the work that defines it has
// completed; on the card the copy runs on the fetch stream.
int32_t aoti_runner_get(AotiRunner* r, int64_t id, void* dst, int64_t nbytes,
                        int32_t on_device) {
  return guarded<int32_t>(r, -1, [&] {
    const Buffer& b = buffer(r, id);
    if (dst == nullptr) throw std::runtime_error("null output pointer");
    if (nbytes != static_cast<int64_t>(b.tensor.nbytes()))
      throw std::runtime_error("buffer " + std::to_string(id) + " is " +
                               std::to_string(b.tensor.nbytes()) + " bytes, not " +
                               std::to_string(nbytes) + " " + shape_str(b.tensor.sizes().vec()));
    auto where = on_device ? r->device : c10::Device(c10::kCPU);
    at::Tensor out = at::from_blob(dst, b.tensor.sizes(),
                                   at::TensorOptions().dtype(b.tensor.scalar_type()).device(where));
    if (!r->on_card()) {
      out.copy_(b.tensor);
      return 0;
    }
    if (b.ready) b.ready->block(*r->fetch_stream);
    c10::StreamGuard guard(*r->fetch_stream);
    out.copy_(b.tensor, /*non_blocking=*/true);
    r->fetch_stream->synchronize();
    return 0;
  });
}

int32_t aoti_runner_free_buffer(AotiRunner* r, int64_t id) {
  return guarded<int32_t>(r, -1, [&] {
    if (r->buffers.erase(id) == 0) throw std::runtime_error("no buffer " + std::to_string(id));
    return 0;
  });
}

int64_t aoti_runner_live_buffers(AotiRunner* r) {
  return guarded<int64_t>(r, -1, [&] {
    return static_cast<int64_t>(r->buffers.size() + r->host_buffers.size());
  });
}

// Page-locked host memory on the card (plain memory on the CPU) for a
// caller's staging buffers, so that a copy from it runs asynchronously;
// counted in aoti_runner_live_buffers until aoti_runner_free_host.
void* aoti_runner_alloc_host(AotiRunner* r, int64_t nbytes) {
  return guarded<void*>(r, nullptr, [&]() -> void* {
    at::Tensor t = at::empty({nbytes}, at::TensorOptions().dtype(at::kByte).pinned_memory(r->on_card()));
    void* p = t.data_ptr();
    r->host_buffers.emplace(p, std::move(t));
    return p;
  });
}

int32_t aoti_runner_free_host(AotiRunner* r, void* p) {
  return guarded<int32_t>(r, -1, [&] {
    if (r->host_buffers.erase(p) == 0)
      throw std::runtime_error("not a host buffer of this runner");
    return 0;
  });
}

// The caller makes no call on `r` after this one; a call in progress on
// another thread completes first.
void aoti_runner_destroy(AotiRunner* r) {
  if (r == nullptr) return;
  try {
    {
      std::lock_guard<std::mutex> lock(r->mu);
      if (r->on_card()) r->stream->synchronize();
    }
    delete r;
  } catch (...) {
  }
}

}  // extern "C"
