// aoti_tool — the standalone native featurizer: no Python in the process.
//
// The port's counterpart of sparkdl_tpu/native/pjrt_tool.cpp (the analog of
// the Scala DeepImageFeaturizer, which ran a frozen graph with no Python):
// it loads an exported program directory (sparkdl_tpu_torch/native/aoti.py's
// export_program) through the runner library (aoti_runner.cpp) onto the
// device its manifest names, reads params.bin once into resident tensors,
// then streams raw batches from a file through the package and appends the
// outputs to another.
//
//   aoti_tool <program_dir> <input.bin> <output.bin>
//
// input.bin: whole batches back to back; a batch is the program's data
// inputs, each dense row-major in the dtype and shape of manifest.txt.
// output.bin: the outputs of every batch, in order, likewise.
//
// Batches stream double-buffered: batch i+1 is read into a page-locked
// staging buffer and its copy in and its run are enqueued before batch i's
// outputs are fetched, as the JAX package's pipelined loop does. A staging
// buffer is refilled only after the copy that read it has completed. Any
// error exits 1 with a message; a package that calls an op registered from
// Python (the port's flash attention) fails at load, naming the op.
//
// Built at first use by sparkdl_tpu_torch/native/featurizer.py's build_tool:
//   g++ -O2 -std=c++17 aoti_tool.cpp <aoti_runner .so> -o aoti_tool
//       -Wl,-rpath,<its directory> <torch's link flags>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

extern "C" {
struct AotiRunner;
AotiRunner* aoti_runner_create(const char* program_dir, const char* device, char* err,
                               int32_t err_len);
const char* aoti_runner_last_error(AotiRunner*);
int64_t aoti_runner_put_async(AotiRunner*, int32_t index, const void* data, int32_t on_device);
int32_t aoti_runner_execute_async(AotiRunner*, const int64_t* ids, int32_t n, int64_t* out_ids);
int32_t aoti_runner_get(AotiRunner*, int64_t id, void* dst, int64_t nbytes, int32_t on_device);
int32_t aoti_runner_free_buffer(AotiRunner*, int64_t id);
int64_t aoti_runner_live_buffers(AotiRunner*);
void* aoti_runner_alloc_host(AotiRunner*, int64_t nbytes);
int32_t aoti_runner_free_host(AotiRunner*, void* p);
void aoti_runner_destroy(AotiRunner*);
}

namespace {

size_t dtype_size(const std::string& d) {
  if (d == "f64" || d == "s64") return 8;
  if (d == "f32" || d == "s32") return 4;
  if (d == "f16" || d == "bf16" || d == "s16") return 2;
  return 1;  // u8, s8, pred
}

double seconds_since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
}

struct InFlight {
  std::vector<int64_t> input_ids, output_ids;
};

}  // namespace

int main(int argc, char** argv) {
  if (argc != 4) {
    std::fprintf(stderr, "usage: %s <program_dir> <input.bin> <output.bin>\n", argv[0]);
    return 2;
  }
  const std::string dir = argv[1], in_path = argv[2], out_path = argv[3];

  // the device and the data inputs' and outputs' sizes
  std::ifstream mf(dir + "/manifest.txt");
  if (!mf) {
    std::fprintf(stderr, "aoti_tool: cannot open %s/manifest.txt\n", dir.c_str());
    return 1;
  }
  std::string device, line;
  std::vector<size_t> input_bytes, output_bytes;
  while (std::getline(mf, line)) {
    std::istringstream ls(line);
    std::string kind, dtype, dims;
    if (!(ls >> kind >> dtype)) continue;
    if (kind == "device") {
      device = dtype;
      continue;
    }
    ls >> dims;
    size_t bytes = dtype_size(dtype);
    if (dims != "scalar") {
      std::istringstream ds(dims);
      std::string tok;
      while (std::getline(ds, tok, ',')) bytes *= static_cast<size_t>(std::stoll(tok));
    }
    if (kind == "input") input_bytes.push_back(bytes);
    if (kind == "output") output_bytes.push_back(bytes);
  }
  if (device.empty()) {
    std::fprintf(stderr, "aoti_tool: %s/manifest.txt names no device\n", dir.c_str());
    return 1;
  }

  const auto t_load = std::chrono::steady_clock::now();
  char err[8192];
  AotiRunner* r = aoti_runner_create(dir.c_str(), device.c_str(), err, sizeof(err));
  if (r == nullptr) {
    std::fprintf(stderr, "aoti_tool: loading %s failed: %s\n", dir.c_str(), err);
    return 1;
  }
  const double load_s = seconds_since(t_load);
  auto die = [&](const char* what) {
    std::fprintf(stderr, "aoti_tool: %s: %s\n", what, aoti_runner_last_error(r));
    aoti_runner_destroy(r);
    return 1;
  };

  size_t batch_bytes = 0;
  for (size_t b : input_bytes) batch_bytes += b;
  std::ifstream in(in_path, std::ios::binary);
  std::ofstream out(out_path, std::ios::binary | std::ios::trunc);
  if (!in || !out) {
    std::fprintf(stderr, "aoti_tool: cannot open %s or %s\n", in_path.c_str(), out_path.c_str());
    aoti_runner_destroy(r);
    return 1;
  }

  // two staging buffers, batch i in slot i % 2
  char* slots[2] = {nullptr, nullptr};
  for (char*& slot : slots) {
    slot = static_cast<char*>(aoti_runner_alloc_host(r, static_cast<int64_t>(batch_bytes) + 1));
    if (slot == nullptr) return die("staging buffer");
  }
  std::vector<std::vector<char>> host(output_bytes.size());
  for (size_t i = 0; i < output_bytes.size(); ++i) host[i].resize(output_bytes[i]);

  auto drain = [&](InFlight& f) -> bool {  // fetch, write, free
    for (size_t i = 0; i < f.output_ids.size(); ++i) {
      if (aoti_runner_get(r, f.output_ids[i], host[i].data(),
                          static_cast<int64_t>(host[i].size()), 0) != 0)
        return false;
      out.write(host[i].data(), static_cast<std::streamsize>(host[i].size()));
    }
    for (int64_t id : f.output_ids) aoti_runner_free_buffer(r, id);
    for (int64_t id : f.input_ids) aoti_runner_free_buffer(r, id);
    return true;
  };

  const auto t_run = std::chrono::steady_clock::now();
  InFlight prev;
  bool have_prev = false;
  size_t n_batches = 0;
  while (true) {
    // the slot was last read by batch i-2's copies, which completed before
    // its outputs (drained in the last turn) were defined
    char* slot = slots[n_batches % 2];
    if (batch_bytes == 0) {
      if (n_batches) break;  // a program of parameters alone runs once
    } else if (!in.read(slot, static_cast<std::streamsize>(batch_bytes))) {
      if (in.gcount() != 0) {
        std::fprintf(stderr,
                     "aoti_tool: input.bin ends in a partial batch (%lld of %zu bytes): "
                     "is the batch shape right?\n",
                     static_cast<long long>(in.gcount()), batch_bytes);
        aoti_runner_destroy(r);
        return 1;
      }
      break;
    }
    InFlight cur;
    size_t off = 0;
    for (size_t i = 0; i < input_bytes.size(); ++i) {
      int64_t id = aoti_runner_put_async(r, static_cast<int32_t>(i), slot + off, 0);
      if (id < 0) return die("batch copy");
      cur.input_ids.push_back(id);
      off += input_bytes[i];
    }
    cur.output_ids.resize(output_bytes.size());
    if (aoti_runner_execute_async(r, cur.input_ids.data(),
                                  static_cast<int32_t>(cur.input_ids.size()),
                                  cur.output_ids.data()) < 0)
      return die("run");
    // with batch i+1 enqueued, fetching batch i overlaps its copy and run
    if (have_prev && !drain(prev)) return die("fetch");
    prev = std::move(cur);
    have_prev = true;
    ++n_batches;
  }
  if (have_prev && !drain(prev)) return die("fetch");
  const double run_s = seconds_since(t_run);
  for (char* slot : slots) aoti_runner_free_host(r, slot);
  const int64_t live = aoti_runner_live_buffers(r);
  std::fprintf(stderr,
               "aoti_tool: device=%s batches=%zu load_s=%.6f run_s=%.6f live_buffers=%lld -> %s\n",
               device.c_str(), n_batches, load_s, run_s, static_cast<long long>(live),
               out_path.c_str());
  aoti_runner_destroy(r);
  out.close();
  return out ? 0 : 1;
}
