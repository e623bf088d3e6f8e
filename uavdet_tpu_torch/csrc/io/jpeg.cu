// JPEG decode and encode on the card through nvJPEG, for the data pipeline
// (uavdet_tpu_torch/data/jpeg.py) and the synthetic dataset writer.
//
// This is I/O, not a port of a TPU kernel: the JAX package decodes on the
// host (PIL, or native/uavloader.cc with libjpeg) and no Pallas kernel
// exists for it. The card's path needs neither Pillow nor OpenCV: frames
// are decoded here and the resize and affine run on the card as torch ops.
//
// A plain C interface loaded with ctypes, built into its own library (the
// seven kernels' library does not link nvJPEG). A codec holds the nvJPEG
// handle (thread safe) and an encoder state; each decoding thread has a
// decoder state of its own (a state decodes one image at a time), and the
// caller serializes the encoder. Decoding is nvjpegDecode per image on the
// caller's stream (the hybrid backend: Huffman decode on the host, the rest
// on the card), into the planes the caller allocated: YCbCr, which the
// caller converts to RGB as libjpeg does, or nvJPEG's interleaved RGB;
// threads decoding at once overlap their host parts. Every function returns 0 or an
// error code: an nvJPEG status below 1000, 1000 + a CUDA error above.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>

namespace {

struct Codec {
  nvjpegHandle_t handle = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
};

constexpr int kCudaBase = 1000;

int cuda_code(cudaError_t e) { return e == cudaSuccess ? 0 : kCudaBase + e; }

nvjpegImage_t rgbi(unsigned char* data, int pitch) {
  nvjpegImage_t img;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    img.channel[c] = nullptr;
    img.pitch[c] = 0;
  }
  img.channel[0] = data;
  img.pitch[0] = pitch;
  return img;
}

}  // namespace

#define UAVJPEG_TRY(call)                      \
  do {                                         \
    nvjpegStatus_t s_ = (call);                \
    if (s_ != NVJPEG_STATUS_SUCCESS) return s_; \
  } while (0)

extern "C" {

const char* uavjpeg_error_string(int code) {
  if (code >= kCudaBase)
    return cudaGetErrorString(cudaError_t(code - kCudaBase));
  switch (code) {
    case 0: return "success";
    case 1: return "NVJPEG_STATUS_NOT_INITIALIZED";
    case 2: return "NVJPEG_STATUS_INVALID_PARAMETER";
    case 3: return "NVJPEG_STATUS_BAD_JPEG";
    case 4: return "NVJPEG_STATUS_JPEG_NOT_SUPPORTED";
    case 5: return "NVJPEG_STATUS_ALLOCATOR_FAILURE";
    case 6: return "NVJPEG_STATUS_EXECUTION_FAILED";
    case 7: return "NVJPEG_STATUS_ARCH_MISMATCH";
    case 8: return "NVJPEG_STATUS_INTERNAL_ERROR";
    case 9: return "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED";
    default: return "nvJPEG status (see nvjpeg.h)";
  }
}

// A codec: an nvJPEG handle with the default backend, and an encoder
// state with parameters (quality and sampling set per call).
int uavjpeg_create(void** out) {
  Codec* c = new Codec();
  *out = nullptr;
  nvjpegStatus_t s = nvjpegCreateSimple(&c->handle);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderStateCreate(c->handle, &c->enc_state, nullptr);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsCreate(c->handle, &c->enc_params, nullptr);
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (c->enc_state) nvjpegEncoderStateDestroy(c->enc_state);
    if (c->handle) nvjpegDestroy(c->handle);
    delete c;
    return s;
  }
  *out = c;
  return 0;
}

void uavjpeg_destroy(void* codec) {
  Codec* c = static_cast<Codec*>(codec);
  if (!c) return;
  nvjpegEncoderParamsDestroy(c->enc_params);
  nvjpegEncoderStateDestroy(c->enc_state);
  nvjpegDestroy(c->handle);
  delete c;
}

// A decoder state of the codec, for one thread.
int uavjpeg_state_create(void* codec, void** out) {
  Codec* c = static_cast<Codec*>(codec);
  nvjpegJpegState_t state = nullptr;
  *out = nullptr;
  UAVJPEG_TRY(nvjpegJpegStateCreate(c->handle, &state));
  *out = state;
  return 0;
}

void uavjpeg_state_destroy(void* state) {
  if (state) nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state));
}

// The header of one JPEG (nvjpegGetImageInfo): the number of components,
// the chroma subsampling (nvjpegChromaSubsampling_t) and each component's
// width and height (NVJPEG_MAX_COMPONENT entries).
int uavjpeg_info(void* codec, const unsigned char* data, size_t length,
                 int* components, int* subsampling, int* widths,
                 int* heights) {
  Codec* c = static_cast<Codec*>(codec);
  nvjpegChromaSubsampling_t css;
  UAVJPEG_TRY(nvjpegGetImageInfo(c->handle, data, length, components, &css,
                                 widths, heights));
  *subsampling = css;
  return 0;
}

// Decode one JPEG with the decoder state ``state`` into the output format
// ``format`` (nvjpegOutputFormat_t) at ``planes[0..2]`` (device memory, row
// pitches ``pitches`` bytes; unused planes null), on ``stream``.
int uavjpeg_decode(void* codec, void* state, const unsigned char* data,
                   size_t length, int format, unsigned char** planes,
                   const int* pitches, void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  nvjpegImage_t img = rgbi(planes[0], pitches[0]);
  for (int k = 1; k < 3; ++k) {
    img.channel[k] = planes[k];
    img.pitch[k] = planes[k] ? pitches[k] : 0;
  }
  UAVJPEG_TRY(nvjpegDecode(c->handle, static_cast<nvjpegJpegState_t>(state),
                           data, length,
                           static_cast<nvjpegOutputFormat_t>(format), &img,
                           static_cast<cudaStream_t>(stream)));
  return cuda_code(cudaGetLastError());
}

// Encode interleaved RGB (H, W, 3) uint8 at ``img`` (device memory, row
// pitch ``pitch`` bytes) with 4:4:4 sampling at ``quality``, on ``stream``;
// waits for the stream and writes the bitstream's length to ``length``.
// ``uavjpeg_retrieve`` then copies the bitstream out.
int uavjpeg_encode_rgbi(void* codec, const unsigned char* img, int height,
                        int width, int pitch, int quality, void* stream,
                        size_t* length) {
  Codec* c = static_cast<Codec*>(codec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UAVJPEG_TRY(nvjpegEncoderParamsSetQuality(c->enc_params, quality, s));
  UAVJPEG_TRY(nvjpegEncoderParamsSetSamplingFactors(c->enc_params,
                                                    NVJPEG_CSS_444, s));
  nvjpegImage_t src = rgbi(const_cast<unsigned char*>(img), pitch);
  UAVJPEG_TRY(nvjpegEncodeImage(c->handle, c->enc_state, c->enc_params, &src,
                                NVJPEG_INPUT_RGBI, width, height, s));
  UAVJPEG_TRY(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, nullptr,
                                            length, s));
  return cuda_code(cudaStreamSynchronize(s));
}

// Copy the last encoded bitstream into ``out`` (host memory of ``*length``
// bytes, as ``uavjpeg_encode_rgbi`` reported it); waits for the stream.
int uavjpeg_retrieve(void* codec, unsigned char* out, size_t* length,
                     void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UAVJPEG_TRY(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, out,
                                            length, s));
  return cuda_code(cudaStreamSynchronize(s));
}

}  // extern "C"
