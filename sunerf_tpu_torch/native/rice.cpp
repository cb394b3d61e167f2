// Rice (RICE_1) tile decompressor for the FITS tiled-image convention.
//
// Implements the standard Rice/Golomb decoder used by the FITS tile
// compression registry (the algorithm of White & Becker 1998, as specified in
// the FITS tiled-image compression convention): per BLOCKSIZE-pixel block a
// fsbits-wide split position, top bits unary-coded, low fs bits verbatim,
// first-difference coding with the even/odd fold to map signed diffs onto
// unsigned codes. Clean-room from the published algorithm; the reference
// project gets this for free via astropy (sunerf/data/utils.py:54-71), which
// is unavailable on this image.
//
// Build: g++ -O3 -shared -fPIC rice.cpp -o librice.so  (see native/build.py)

#include <cstdint>

namespace {

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool err = false;

  BitReader(const uint8_t* buf, long len) : p(buf), end(buf + len) {}

  uint32_t get(int n) {  // n <= 32
    while (nbits < n) {
      if (p >= end) {
        err = true;
        return 0;
      }
      acc = (acc << 8) | *p++;
      nbits += 8;
    }
    nbits -= n;
    return (uint32_t)((acc >> nbits) &
                      ((n >= 32) ? 0xffffffffULL : ((1ULL << n) - 1)));
  }

  // number of 0 bits before the next 1 bit; consumes the terminating 1
  int unary() {
    int count = 0;
    for (;;) {
      if (nbits == 0) {
        if (p >= end) {
          err = true;
          return 0;
        }
        acc = *p++;
        nbits = 8;
      }
      uint64_t window = acc & ((1ULL << nbits) - 1);
      if (window == 0) {
        count += nbits;
        nbits = 0;
        continue;
      }
      int top = 63 - __builtin_clzll(window);
      count += nbits - 1 - top;
      nbits = top;  // zeros and the 1 bit are consumed
      return count;
    }
  }
};

template <typename T>
int rice_decode_t(const uint8_t* buf, long nbuf, T* out, long npix, int nblock,
                  int fsbits, int fsmax) {
  BitReader br(buf, nbuf);
  const int bbits = (int)sizeof(T) * 8;
  uint32_t lastpix = 0;
  for (unsigned k = 0; k < sizeof(T); k++)
    lastpix = (lastpix << 8) | br.get(8);
  if (br.err) return 1;

  long i = 0;
  while (i < npix) {
    int fs = (int)br.get(fsbits) - 1;
    if (br.err) return 1;
    long imax = (i + nblock < npix) ? i + nblock : npix;
    if (fs < 0) {  // zero-entropy block: every pixel equals the previous
      for (; i < imax; i++) out[i] = (T)lastpix;
    } else if (fs == fsmax) {  // incompressible block: verbatim diffs
      for (; i < imax; i++) {
        uint32_t diff = br.get(bbits);
        if (br.err) return 1;
        diff = (diff & 1) ? ~(diff >> 1) : (diff >> 1);
        lastpix += diff;
        out[i] = (T)lastpix;
      }
    } else {  // Rice block: unary high bits, fs verbatim low bits
      for (; i < imax; i++) {
        uint32_t diff = ((uint32_t)br.unary() << fs);
        if (fs > 0) diff |= br.get(fs);
        if (br.err) return 1;
        diff = (diff & 1) ? ~(diff >> 1) : (diff >> 1);
        lastpix += diff;
        out[i] = (T)lastpix;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" int rice_decode(const uint8_t* buf, long nbuf, void* out, long npix,
                           int bytepix, int nblock) {
  switch (bytepix) {
    case 1:
      return rice_decode_t(buf, nbuf, (uint8_t*)out, npix, nblock, 3, 6);
    case 2:
      return rice_decode_t(buf, nbuf, (int16_t*)out, npix, nblock, 4, 14);
    case 4:
      return rice_decode_t(buf, nbuf, (int32_t*)out, npix, nblock, 5, 25);
  }
  return 2;  // unsupported BYTEPIX
}
