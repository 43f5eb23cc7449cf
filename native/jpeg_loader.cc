// Native JPEG decode for the data-loader path (libjpeg).
//
// The reference's data layer decodes JPEGs through OpenCV's C++ imread
// (SURVEY §2.3 I/O row). Here decode is a C call that releases the GIL
// (ctypes does this automatically), so the Python-side prefetcher overlaps
// many decodes with device compute (host->device pipelining, SURVEY §2.4).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

}  // namespace

extern "C" {

// Parse header only; returns 0 on success and fills (h, w, channels).
int stereo_native_jpeg_info(const uint8_t* data, size_t size, int* h, int* w,
                            int* channels) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  *channels = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode into caller-allocated buffer. gray != 0 -> single-channel
// grayscale (libjpeg's BT.601 luma, matching cv2.IMREAD_GRAYSCALE);
// otherwise RGB. Returns 0 on success.
int stereo_native_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out,
                              int gray) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int stride = cinfo.output_width * cinfo.output_components;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
