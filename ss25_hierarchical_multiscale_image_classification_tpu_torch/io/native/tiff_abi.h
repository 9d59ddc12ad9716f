// The part of libtiff 4.x's C interface that tile_decoder.cpp uses, for a
// machine that has the runtime library (libtiff.so.N) but not its headers.
// ops/build.py compiles tile_decoder.cpp with -DHIPAC_TIFF_ABI and links the
// library it found; where <tiffio.h> exists it is used instead.
//
// Values are those of libtiff's tiff.h and tiffio.h, which libtiff keeps
// stable across 4.x. tdir_t became uint32_t in 4.5 (uint16_t before): it is
// passed in a register, so a 4.0-4.4 library reads the same low 16 bits.

#pragma once

#include <cstdarg>
#include <cstdint>

extern "C" {

typedef struct tiff TIFF;
typedef int64_t tmsize_t;
typedef uint32_t tdir_t;
typedef void (*TIFFErrorHandler)(const char*, const char*, va_list);

const char* TIFFGetVersion(void);
TIFF* TIFFOpen(const char* path, const char* mode);
void TIFFClose(TIFF* tif);
int TIFFSetDirectory(TIFF* tif, tdir_t dir);
int TIFFReadDirectory(TIFF* tif);
int TIFFGetField(TIFF* tif, uint32_t tag, ...);
int TIFFGetFieldDefaulted(TIFF* tif, uint32_t tag, ...);
int TIFFSetField(TIFF* tif, uint32_t tag, ...);
int TIFFIsTiled(TIFF* tif);
int TIFFReadRGBATile(TIFF* tif, uint32_t x, uint32_t y, uint32_t* raster);
int TIFFReadRGBAStrip(TIFF* tif, uint32_t row, uint32_t* raster);
tmsize_t TIFFWriteTile(TIFF* tif, void* buf, uint32_t x, uint32_t y,
                       uint32_t z, uint16_t sample);
int TIFFWriteDirectory(TIFF* tif);
TIFFErrorHandler TIFFSetWarningHandler(TIFFErrorHandler handler);

}  // extern "C"

// tags (tiff.h)
#define TIFFTAG_SUBFILETYPE 254
#define FILETYPE_REDUCEDIMAGE 0x1
#define TIFFTAG_IMAGEWIDTH 256
#define TIFFTAG_IMAGELENGTH 257
#define TIFFTAG_BITSPERSAMPLE 258
#define TIFFTAG_COMPRESSION 259
#define COMPRESSION_NONE 1
#define COMPRESSION_JPEG 7
#define COMPRESSION_ADOBE_DEFLATE 8
#define TIFFTAG_PHOTOMETRIC 262
#define PHOTOMETRIC_RGB 2
#define PHOTOMETRIC_YCBCR 6
#define TIFFTAG_ORIENTATION 274
#define ORIENTATION_TOPLEFT 1
#define TIFFTAG_SAMPLESPERPIXEL 277
#define TIFFTAG_ROWSPERSTRIP 278
#define TIFFTAG_PLANARCONFIG 284
#define PLANARCONFIG_CONTIG 1
#define TIFFTAG_TILEWIDTH 322
#define TIFFTAG_TILELENGTH 323
#define TIFFTAG_YCBCRSUBSAMPLING 530
// pseudo-tags of libtiff's JPEG codec
#define TIFFTAG_JPEGQUALITY 65537
#define TIFFTAG_JPEGCOLORMODE 65538
#define JPEGCOLORMODE_RGB 0x0001

// the channels of a TIFFReadRGBA* pixel (tiffio.h)
#define TIFFGetR(abgr) ((abgr) & 0xff)
#define TIFFGetG(abgr) (((abgr) >> 8) & 0xff)
#define TIFFGetB(abgr) (((abgr) >> 16) & 0xff)
