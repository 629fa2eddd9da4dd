// JPEG decode on the card through nvJPEG, for data/image_io.py, and
// nvJPEG's encoder, the yardstick K11 (csrc/jpeg_encode.cu) is timed beside.
//
// Not a kernel of the repository: the JAX package decodes photos with PIL
// on the host, and the card's machine has no PIL, so the port asks the CUDA
// toolkit's own decoder. Host code only; built by data/image_io.py with
// nvcc against libnvjpeg into its own library (build/nvjpeg/), never into
// the kernel library, so a toolkit without nvJPEG cannot stop K1-K11 from
// building.
//
// One handle and one decode state serve the process, created at the first
// call and kept until it exits; a mutex serialises the calls (ctypes
// releases the interpreter lock). The caller allocates the output (torch's
// caching allocator owns it) and names the stream (torch's current one).
// The encoder's state and parameters are made at its first call and kept
// likewise; nothing of the port encodes with it (its bytes are not
// libjpeg's): chip_smoke.py times it beside K11.
// Every entry returns 0, an nvjpegStatus_t, or 1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <mutex>

namespace {

std::mutex g_mutex;
nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;
nvjpegEncoderState_t g_enc_state = nullptr;
nvjpegEncoderParams_t g_enc_params = nullptr;

int ensure_handle() {
  if (g_state != nullptr) return 0;
  nvjpegStatus_t s = nvjpegCreateSimple(&g_handle);
  if (s != NVJPEG_STATUS_SUCCESS) {
    g_handle = nullptr;
    return static_cast<int>(s);
  }
  s = nvjpegJpegStateCreate(g_handle, &g_state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(g_handle);
    g_handle = nullptr;
    g_state = nullptr;
    return static_cast<int>(s);
  }
  return 0;
}

int ensure_encoder(cudaStream_t stream) {
  if (int s = ensure_handle()) return s;
  if (g_enc_params != nullptr) return 0;
  nvjpegStatus_t s = nvjpegEncoderStateCreate(g_handle, &g_enc_state, stream);
  if (s != NVJPEG_STATUS_SUCCESS) {
    g_enc_state = nullptr;
    return static_cast<int>(s);
  }
  s = nvjpegEncoderParamsCreate(g_handle, &g_enc_params, stream);
  if (s != NVJPEG_STATUS_SUCCESS) {
    nvjpegEncoderStateDestroy(g_enc_state);
    g_enc_state = nullptr;
    g_enc_params = nullptr;
    return static_cast<int>(s);
  }
  return 0;
}

}  // namespace

extern "C" {

// info[0..3] = components, nvjpegChromaSubsampling_t, width, height (of
// the full-resolution component).
int egs_nvjpeg_info(const unsigned char* data, size_t length, int* info) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (int s = ensure_handle()) return s;
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegStatus_t s = nvjpegGetImageInfo(g_handle, data, length, &components, &subsampling,
                                        widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  info[0] = components;
  info[1] = static_cast<int>(subsampling);
  info[2] = widths[0];
  info[3] = heights[0];
  return 0;
}

// Decodes to interleaved RGB (NVJPEG_OUTPUT_RGBI) at `out`, rows `pitch`
// bytes apart, on `stream`, and waits for the stream: the state's buffers
// and `data` are free for the next call when this returns.
int egs_nvjpeg_decode(const unsigned char* data, size_t length, void* out, int pitch,
                      void* stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (int s = ensure_handle()) return s;
  nvjpegImage_t image = {};
  image.channel[0] = static_cast<unsigned char*>(out);
  image.pitch[0] = static_cast<size_t>(pitch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t s = nvjpegDecode(g_handle, g_state, data, length, NVJPEG_OUTPUT_RGBI, &image,
                                  st);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  cudaError_t e = cudaStreamSynchronize(st);
  if (e != cudaSuccess) return 1000 + static_cast<int>(e);
  return 0;
}

// Encodes interleaved RGB at `rgb` (rows `pitch` bytes apart) as a
// baseline 4:2:0 JPEG of `quality` into the encoder's state, on `stream`,
// without waiting for it.
int egs_nvjpeg_encode(const void* rgb, int pitch, int width, int height, int quality,
                      void* stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int s = ensure_encoder(st)) return s;
  nvjpegStatus_t s = nvjpegEncoderParamsSetQuality(g_enc_params, quality, st);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsSetSamplingFactors(g_enc_params, NVJPEG_CSS_420, st);
  if (s == NVJPEG_STATUS_SUCCESS) s = nvjpegEncoderParamsSetOptimizedHuffman(g_enc_params, 0, st);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  nvjpegImage_t image = {};
  image.channel[0] = static_cast<unsigned char*>(const_cast<void*>(rgb));
  image.pitch[0] = static_cast<size_t>(pitch);
  s = nvjpegEncodeImage(g_handle, g_enc_state, g_enc_params, &image, NVJPEG_INPUT_RGBI, width,
                        height, st);
  return static_cast<int>(s);
}

// The last encode's bytes: its length to *length, and the bytes to `out`
// unless it is null (then *length only). Waits for `stream`.
int egs_nvjpeg_encoded(unsigned char* out, size_t* length, void* stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_enc_state == nullptr) return static_cast<int>(NVJPEG_STATUS_NOT_INITIALIZED);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t s = nvjpegEncodeRetrieveBitstream(g_handle, g_enc_state, out, length, st);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  cudaError_t e = cudaStreamSynchronize(st);
  if (e != cudaSuccess) return 1000 + static_cast<int>(e);
  return 0;
}

}  // extern "C"
