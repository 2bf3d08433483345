// PyTorch bindings of the port's kernels. The only translation unit
// that includes torch/extension.h: the .cu files export plain C launchers
// (also loadable with ctypes) and compile without PyTorch's headers.
//
// Every launch follows its first tensor's device: a device guard makes it
// the current device (so the launcher's cudaFuncSetAttribute calls apply
// to it), every other tensor must be on it, and the kernel goes on that
// device's current stream.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
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
int rtt_rows_walk(const int32_t* moves, const int32_t* m, const int32_t* n,
                  uint8_t* payload, int B, int m_cap, int n_cap, int W,
                  cudaStream_t stream);
int rtt_packed_walk(const int32_t* moves, const int32_t* m, const int32_t* n,
                    uint8_t* payload, int B, int m_cap, int n_cap, int W,
                    int S, cudaStream_t stream);
int rtt_myers_sweep(const uint8_t* q4, const uint8_t* t4, int32_t* planes,
                    int B, int m_cap, int n_cap, int W, cudaStream_t stream);
int rtt_myers_walk(const int32_t* planes, const int32_t* m, const int32_t* n,
                   uint8_t* payload, int B, int m_cap, int n_cap, int W,
                   cudaStream_t stream);
int rtt_nw_sweep_t(const int32_t* q, const int32_t* tp, const int32_t* gcp,
                   int32_t* moves, int32_t* score, int B, int m_cap, int n_cap,
                   int W, int match, int mismatch, int gap, int span,
                   int variant, cudaStream_t stream);
int rtt_nw_sweep16(const uint8_t* q4, const uint8_t* t4, const uint8_t* dcb,
                   int32_t* moves, int32_t* score, int B, int m_cap,
                   int n_cap, int W, int match, int mismatch, int gap,
                   int span, int neg, cudaStream_t stream);
int rtt_pack_gather(const int32_t* qb, int nq, const int32_t* tb, int nt,
                    const int32_t* db, int nd, const int32_t* meta,
                    uint8_t* q4, uint8_t* t4, uint8_t* dcb, int B, int m_cap,
                    int n_cap, cudaStream_t stream);
int rtt_myers_moves(const int32_t* planes, const int32_t* m, int32_t* moves,
                    int B, int m_cap, int n_cap, int W, cudaStream_t stream);
const char* rtt_error_string(int e);
}

namespace {

// The device of a launch: its first tensor's, which must be a CUDA one.
at::Device launch_device(const at::Tensor& first, const char* name) {
  TORCH_CHECK(first.is_cuda(), name, " must be a CUDA tensor");
  return first.device();
}

void check(const at::Tensor& t, const char* name, at::ScalarType dtype,
           std::vector<int64_t> shape, const at::Device& dev) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == dev, name, " is on ", t.device(),
              ", the launch on ", dev);
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

cudaStream_t stream(const at::Device& dev) {
  return c10::cuda::getCurrentCUDAStream(dev.index()).stream();
}

void nw_sweep(const at::Tensor& q4, const at::Tensor& t4,
              const at::Tensor& dcb, const at::Tensor& moves,
              const at::Tensor& score, int64_t m_cap, int64_t n_cap,
              int64_t W, int64_t match, int64_t mismatch, int64_t gap,
              int64_t span) {
  const int64_t B = q4.size(0);
  const at::Device dev = launch_device(q4, "q4");
  const c10::cuda::CUDAGuard guard(dev);
  check(q4, "q4", at::kByte, {B, m_cap / 2}, dev);
  check(t4, "t4", at::kByte, {B, n_cap / 2}, dev);
  check(dcb, "dcb", at::kByte, {B, n_cap / 8}, dev);
  check(moves, "moves", at::kInt, {B, m_cap / 16, W}, dev);
  check(score, "score", at::kInt, {B}, dev);
  const int64_t lanes = W <= 1024 ? 1 : (W <= 2048 ? 2 : 4);
  TORCH_CHECK(W % (32 * lanes) == 0 && W <= 4096 &&
              m_cap % 16 == 0 && n_cap % 32 == 0 &&
              n_cap - m_cap - W / 2 <= 0,
              "nw_sweep: unsupported geometry");
  done(rtt_nw_sweep(q4.data_ptr<uint8_t>(), t4.data_ptr<uint8_t>(),
                    dcb.data_ptr<uint8_t>(), moves.data_ptr<int32_t>(),
                    score.data_ptr<int32_t>(), B, m_cap, n_cap, W, match,
                    mismatch, gap, span, stream(dev)));
}

void nw_sweep16(const at::Tensor& q4, const at::Tensor& t4,
                const at::Tensor& dcb, const at::Tensor& moves,
                const at::Tensor& score, int64_t m_cap, int64_t n_cap,
                int64_t W, int64_t match, int64_t mismatch, int64_t gap,
                int64_t span, int64_t neg) {
  const int64_t B = q4.size(0);
  const at::Device dev = launch_device(q4, "q4");
  const c10::cuda::CUDAGuard guard(dev);
  check(q4, "q4", at::kByte, {B, m_cap / 2}, dev);
  check(t4, "t4", at::kByte, {B, n_cap / 2}, dev);
  check(dcb, "dcb", at::kByte, {B, n_cap / 8}, dev);
  check(moves, "moves", at::kInt, {B, m_cap / 16, W}, dev);
  check(score, "score", at::kInt, {B}, dev);
  TORCH_CHECK(W % 32 == 0 && W > 0 && W <= 1024 && m_cap % 16 == 0 &&
              n_cap % 32 == 0 && n_cap - m_cap - W / 2 <= 0 &&
              neg >= -15000 && neg < 0,
              "nw_sweep16: unsupported geometry");
  done(rtt_nw_sweep16(q4.data_ptr<uint8_t>(), t4.data_ptr<uint8_t>(),
                      dcb.data_ptr<uint8_t>(), moves.data_ptr<int32_t>(),
                      score.data_ptr<int32_t>(), B, m_cap, n_cap, W, match,
                      mismatch, gap, span, neg, stream(dev)));
}

void rle_walk(const at::Tensor& moves, const at::Tensor& m,
              const at::Tensor& n, const at::Tensor& payload, int64_t m_cap,
              int64_t n_cap, int64_t W, int64_t E) {
  const int64_t B = moves.size(0);
  const at::Device dev = launch_device(moves, "moves");
  const c10::cuda::CUDAGuard guard(dev);
  check(moves, "moves", at::kInt, {B, m_cap / 16, W}, dev);
  check(m, "m", at::kInt, {B}, dev);
  check(n, "n", at::kInt, {B}, dev);
  check(payload, "payload", at::kByte, {B, E + 1}, dev);
  done(rtt_rle_walk(moves.data_ptr<int32_t>(), m.data_ptr<int32_t>(),
                    n.data_ptr<int32_t>(), payload.data_ptr<uint8_t>(), B,
                    m_cap, n_cap, W, E, stream(dev)));
}

void rows_walk(const at::Tensor& moves, const at::Tensor& m,
               const at::Tensor& n, const at::Tensor& payload, int64_t m_cap,
               int64_t n_cap, int64_t W) {
  const int64_t B = moves.size(0);
  const at::Device dev = launch_device(moves, "moves");
  const c10::cuda::CUDAGuard guard(dev);
  check(moves, "moves", at::kInt, {B, m_cap / 16, W}, dev);
  check(m, "m", at::kInt, {B}, dev);
  check(n, "n", at::kInt, {B}, dev);
  check(payload, "payload", at::kByte, {B, m_cap + 2}, dev);
  done(rtt_rows_walk(moves.data_ptr<int32_t>(), m.data_ptr<int32_t>(),
                     n.data_ptr<int32_t>(), payload.data_ptr<uint8_t>(), B,
                     m_cap, n_cap, W, stream(dev)));
}

void packed_walk(const at::Tensor& moves, const at::Tensor& m,
                 const at::Tensor& n, const at::Tensor& payload,
                 int64_t m_cap, int64_t n_cap, int64_t W, int64_t S) {
  const int64_t B = moves.size(0);
  const at::Device dev = launch_device(moves, "moves");
  const c10::cuda::CUDAGuard guard(dev);
  check(moves, "moves", at::kInt, {B, m_cap / 16, W}, dev);
  check(m, "m", at::kInt, {B}, dev);
  check(n, "n", at::kInt, {B}, dev);
  check(payload, "payload", at::kByte, {B, S / 4 + 1}, dev);
  TORCH_CHECK(S % 4 == 0, "packed_walk: step budget must be a multiple of 4");
  done(rtt_packed_walk(moves.data_ptr<int32_t>(), m.data_ptr<int32_t>(),
                       n.data_ptr<int32_t>(), payload.data_ptr<uint8_t>(), B,
                       m_cap, n_cap, W, S, stream(dev)));
}

void myers_sweep(const at::Tensor& q4, const at::Tensor& t4,
                 const at::Tensor& planes, int64_t m_cap, int64_t n_cap,
                 int64_t W) {
  const int64_t B = q4.size(0);
  const at::Device dev = launch_device(q4, "q4");
  const c10::cuda::CUDAGuard guard(dev);
  check(q4, "q4", at::kByte, {B, m_cap / 2}, dev);
  check(t4, "t4", at::kByte, {B, n_cap / 2}, dev);
  check(planes, "planes", at::kInt, {B, m_cap, 2, W / 32}, dev);
  TORCH_CHECK(W % 32 == 0 && W <= 4096 && m_cap == n_cap,
              "myers_sweep: unsupported geometry");
  done(rtt_myers_sweep(q4.data_ptr<uint8_t>(), t4.data_ptr<uint8_t>(),
                       planes.data_ptr<int32_t>(), B, m_cap, n_cap, W,
                       stream(dev)));
}

void myers_walk(const at::Tensor& planes, const at::Tensor& m,
                const at::Tensor& n, const at::Tensor& payload,
                int64_t m_cap, int64_t n_cap, int64_t W) {
  const int64_t B = planes.size(0);
  const at::Device dev = launch_device(planes, "planes");
  const c10::cuda::CUDAGuard guard(dev);
  check(planes, "planes", at::kInt, {B, m_cap, 2, W / 32}, dev);
  check(m, "m", at::kInt, {B}, dev);
  check(n, "n", at::kInt, {B}, dev);
  check(payload, "payload", at::kByte, {B, m_cap + 2}, dev);
  done(rtt_myers_walk(planes.data_ptr<int32_t>(), m.data_ptr<int32_t>(),
                      n.data_ptr<int32_t>(), payload.data_ptr<uint8_t>(), B,
                      m_cap, n_cap, W, stream(dev)));
}

void nw_sweep_t(const at::Tensor& q, const at::Tensor& tp,
                const at::Tensor& gcp, const at::Tensor& moves,
                const at::Tensor& score, int64_t m_cap, int64_t n_cap,
                int64_t W, int64_t match, int64_t mismatch, int64_t gap,
                int64_t span, int64_t variant) {
  const int64_t B = q.size(0);
  const at::Device dev = launch_device(q, "q");
  const c10::cuda::CUDAGuard guard(dev);
  check(q, "q", at::kInt, {B, m_cap}, dev);
  check(tp, "tp", at::kInt, {B, n_cap + 2 * W}, dev);
  check(gcp, "gcp", at::kInt, {B, n_cap + 1 + 2 * W}, dev);
  check(moves, "moves", at::kInt, {B, m_cap / 16, W}, dev);
  check(score, "score", at::kInt, {B}, dev);
  TORCH_CHECK(W % 32 == 0 && W > 0 && W <= 1024 && m_cap % 128 == 0 &&
              2 * (n_cap - m_cap) + W >= 0,
              "nw_sweep_t: unsupported geometry");
  TORCH_CHECK(variant >= 0 && variant <= 4, "nw_sweep_t: unknown variant ",
              variant);
  done(rtt_nw_sweep_t(q.data_ptr<int32_t>(), tp.data_ptr<int32_t>(),
                      gcp.data_ptr<int32_t>(), moves.data_ptr<int32_t>(),
                      score.data_ptr<int32_t>(), B, m_cap, n_cap, W, match,
                      mismatch, gap, span, variant, stream(dev)));
}

void pack_gather(const at::Tensor& qb, const at::Tensor& tb,
                 const at::Tensor& db, const at::Tensor& meta,
                 const at::Tensor& q4, const at::Tensor& t4,
                 const at::Tensor& dcb, int64_t m_cap, int64_t n_cap) {
  const int64_t B = meta.size(0);
  const at::Device dev = launch_device(meta, "meta");
  const c10::cuda::CUDAGuard guard(dev);
  check(qb, "qblob", at::kInt, {qb.size(0)}, dev);
  check(tb, "tblob", at::kInt, {tb.size(0)}, dev);
  check(db, "dcblob", at::kInt, {db.size(0)}, dev);
  check(meta, "meta", at::kInt, {B, 4}, dev);
  check(q4, "q4", at::kByte, {B, m_cap / 2}, dev);
  check(t4, "t4", at::kByte, {B, n_cap / 2}, dev);
  check(dcb, "dcb", at::kByte, {B, n_cap / 8}, dev);
  TORCH_CHECK(m_cap % 8 == 0 && n_cap % 32 == 0 && m_cap > 0 && n_cap > 0,
              "pack_gather: unsupported geometry");
  TORCH_CHECK(qb.size(0) < (1LL << 31) && tb.size(0) < (1LL << 31) &&
              db.size(0) < (1LL << 31), "pack_gather: blob too large");
  done(rtt_pack_gather(qb.data_ptr<int32_t>(), qb.size(0),
                       tb.data_ptr<int32_t>(), tb.size(0),
                       db.data_ptr<int32_t>(), db.size(0),
                       meta.data_ptr<int32_t>(), q4.data_ptr<uint8_t>(),
                       t4.data_ptr<uint8_t>(), dcb.data_ptr<uint8_t>(), B,
                       m_cap, n_cap, stream(dev)));
}

void myers_moves(const at::Tensor& planes, const at::Tensor& m,
                 const at::Tensor& moves, int64_t m_cap, int64_t n_cap,
                 int64_t W) {
  const int64_t B = planes.size(0);
  const at::Device dev = launch_device(planes, "planes");
  const c10::cuda::CUDAGuard guard(dev);
  check(planes, "planes", at::kInt, {B, m_cap, 2, W / 32}, dev);
  check(m, "m", at::kInt, {B}, dev);
  check(moves, "moves", at::kInt, {B, m_cap / 16, W}, dev);
  TORCH_CHECK(W % 32 == 0 && W > 0 && m_cap % 16 == 0,
              "myers_moves: unsupported geometry");
  done(rtt_myers_moves(planes.data_ptr<int32_t>(), m.data_ptr<int32_t>(),
                       moves.data_ptr<int32_t>(), B, m_cap, n_cap, W,
                       stream(dev)));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("nw_sweep", &nw_sweep);
  mod.def("nw_sweep16", &nw_sweep16);
  mod.def("rle_walk", &rle_walk);
  mod.def("rows_walk", &rows_walk);
  mod.def("packed_walk", &packed_walk);
  mod.def("myers_sweep", &myers_sweep);
  mod.def("myers_walk", &myers_walk);
  mod.def("nw_sweep_t", &nw_sweep_t);
  mod.def("pack_gather", &pack_gather);
  mod.def("myers_moves", &myers_moves);
}
