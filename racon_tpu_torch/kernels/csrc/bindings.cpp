// PyTorch bindings of the port's four kernels. The only translation unit
// that includes torch/extension.h: the .cu files export plain C launchers
// (also loadable with ctypes) and compile without PyTorch's headers.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAStream.h>

#include <cstdint>

extern "C" {
int rtt_nw_sweep(const uint8_t* q4, const uint8_t* t4, const uint8_t* dcb,
                 int32_t* moves, int32_t* score, int B, int m_cap, int n_cap,
                 int W, int match, int mismatch, int gap, int span,
                 cudaStream_t stream);
int rtt_rle_walk(const int32_t* moves, const int32_t* m, const int32_t* n,
                 uint8_t* payload, int B, int m_cap, int n_cap, int W, int E,
                 cudaStream_t stream);
int rtt_myers_sweep(const uint8_t* q4, const uint8_t* t4, int32_t* planes,
                    int B, int m_cap, int n_cap, int W, cudaStream_t stream);
int rtt_myers_walk(const int32_t* planes, const int32_t* m, const int32_t* n,
                   uint8_t* payload, int B, int m_cap, int n_cap, int W,
                   cudaStream_t stream);
const char* rtt_error_string(int e);
}

namespace {

void check(const at::Tensor& t, const char* name, at::ScalarType dtype,
           std::vector<int64_t> shape) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype, name, " has dtype ", t.scalar_type(),
              ", expected ", dtype);
  TORCH_CHECK(t.sizes() == at::IntArrayRef(shape), name, " has shape ",
              t.sizes(), ", expected ", at::IntArrayRef(shape));
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void done(int rc) {
  TORCH_CHECK(rc == 0, "kernel launch failed: ", rtt_error_string(rc));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

cudaStream_t stream() { return c10::cuda::getCurrentCUDAStream().stream(); }

void nw_sweep(const at::Tensor& q4, const at::Tensor& t4,
              const at::Tensor& dcb, const at::Tensor& moves,
              const at::Tensor& score, int64_t m_cap, int64_t n_cap,
              int64_t W, int64_t match, int64_t mismatch, int64_t gap,
              int64_t span) {
  const int64_t B = q4.size(0);
  check(q4, "q4", at::kByte, {B, m_cap / 2});
  check(t4, "t4", at::kByte, {B, n_cap / 2});
  check(dcb, "dcb", at::kByte, {B, n_cap / 8});
  check(moves, "moves", at::kInt, {B, m_cap / 16, W});
  check(score, "score", at::kInt, {B});
  TORCH_CHECK(W % 32 == 0 && W <= 1024 && m_cap % 16 == 0 &&
              n_cap % 32 == 0 && n_cap - m_cap - W / 2 <= 0,
              "nw_sweep: unsupported geometry");
  done(rtt_nw_sweep(q4.data_ptr<uint8_t>(), t4.data_ptr<uint8_t>(),
                    dcb.data_ptr<uint8_t>(), moves.data_ptr<int32_t>(),
                    score.data_ptr<int32_t>(), B, m_cap, n_cap, W, match,
                    mismatch, gap, span, stream()));
}

void rle_walk(const at::Tensor& moves, const at::Tensor& m,
              const at::Tensor& n, const at::Tensor& payload, int64_t m_cap,
              int64_t n_cap, int64_t W, int64_t E) {
  const int64_t B = moves.size(0);
  check(moves, "moves", at::kInt, {B, m_cap / 16, W});
  check(m, "m", at::kInt, {B});
  check(n, "n", at::kInt, {B});
  check(payload, "payload", at::kByte, {B, E + 1});
  done(rtt_rle_walk(moves.data_ptr<int32_t>(), m.data_ptr<int32_t>(),
                    n.data_ptr<int32_t>(), payload.data_ptr<uint8_t>(), B,
                    m_cap, n_cap, W, E, stream()));
}

void myers_sweep(const at::Tensor& q4, const at::Tensor& t4,
                 const at::Tensor& planes, int64_t m_cap, int64_t n_cap,
                 int64_t W) {
  const int64_t B = q4.size(0);
  check(q4, "q4", at::kByte, {B, m_cap / 2});
  check(t4, "t4", at::kByte, {B, n_cap / 2});
  check(planes, "planes", at::kInt, {B, m_cap, 2, W / 32});
  TORCH_CHECK(W % 32 == 0 && W <= 4096 && m_cap == n_cap,
              "myers_sweep: unsupported geometry");
  done(rtt_myers_sweep(q4.data_ptr<uint8_t>(), t4.data_ptr<uint8_t>(),
                       planes.data_ptr<int32_t>(), B, m_cap, n_cap, W,
                       stream()));
}

void myers_walk(const at::Tensor& planes, const at::Tensor& m,
                const at::Tensor& n, const at::Tensor& payload,
                int64_t m_cap, int64_t n_cap, int64_t W) {
  const int64_t B = planes.size(0);
  check(planes, "planes", at::kInt, {B, m_cap, 2, W / 32});
  check(m, "m", at::kInt, {B});
  check(n, "n", at::kInt, {B});
  check(payload, "payload", at::kByte, {B, m_cap + 2});
  done(rtt_myers_walk(planes.data_ptr<int32_t>(), m.data_ptr<int32_t>(),
                      n.data_ptr<int32_t>(), payload.data_ptr<uint8_t>(), B,
                      m_cap, n_cap, W, stream()));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("nw_sweep", &nw_sweep);
  mod.def("rle_walk", &rle_walk);
  mod.def("myers_sweep", &myers_sweep);
  mod.def("myers_walk", &myers_walk);
}
