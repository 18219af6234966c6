// Tile scheduling orders (preview/progressive scheduling support).
//
// Native equivalent of the reference work queue's tile ordering
// (work_queue.cpp:33-127): tiles are traversed along a bit-REVERSED
// ("inverted") Hilbert curve over the next-pow2 square so a progressive
// render refines uniformly across the screen instead of sweeping. Morton
// and plain bit-reverse orders are kept as the reference's compile-time
// alternatives (work_queue.cpp:48-60, HILBERT/INVERT switches).
//
// On the device the *work distribution* itself is static sharding (no atomic
// queue needed — parallel/render.py); this order is used by the
// progressive/preview host loop and the CLI to decide which tile batches
// to render first, and by checkpointing to name completed slices.

#include <cstdint>

namespace {

// xy -> distance along a Hilbert curve of order `order` (2^order x 2^order).
// Standard Wikipedia formulation; matches the reference's incremental
// variant (work_queue.cpp:86-106).
uint32_t hilbert_d(uint32_t order, uint32_t x, uint32_t y) {
  uint32_t rx, ry, d = 0;
  for (uint32_t s = order / 2; s > 0; s /= 2) {
    rx = (x & s) > 0;
    ry = (y & s) > 0;
    d += s * s * ((3 * rx) ^ ry);
    // rotate
    if (ry == 0) {
      if (rx == 1) {
        x = s - 1 - x;
        y = s - 1 - y;
      }
      uint32_t t = x;
      x = y;
      y = t;
    }
  }
  return d;
}

uint32_t morton_d(uint32_t x, uint32_t y) {
  uint32_t d = 0;
  for (int b = 0; b < 16; ++b) {
    d |= ((x >> b) & 1u) << (2 * b);
    d |= ((y >> b) & 1u) << (2 * b + 1);
  }
  return d;
}

uint32_t bit_reverse(uint32_t v, uint32_t bits) {
  uint32_t r = 0;
  for (uint32_t b = 0; b < bits; ++b) r |= ((v >> b) & 1u) << (bits - 1 - b);
  return r;
}

uint32_t next_pow2(uint32_t v) {
  v -= 1;
  v |= v >> 1; v |= v >> 2; v |= v >> 4; v |= v >> 8; v |= v >> 16;
  return v + 1;
}

uint32_t log2u(uint32_t v) {
  uint32_t r = 0;
  while (v >>= 1) ++r;
  return r;
}

}  // namespace

extern "C" {

// Writes the tile visit order for a tiles_x x tiles_y grid into `out`
// (tiles_x*tiles_y entries, each a tile index = tx + ty*tiles_x).
// mode: 0 = row major, 1 = Morton, 2 = Hilbert, |invert| bit 4 (16) =
// bit-reversed sequence (the reference default is Hilbert+invert,
// work_queue.cpp:84-127).
void mrt_tile_order(int32_t tiles_x, int32_t tiles_y, int32_t mode,
                    int32_t* out) {
  const uint32_t nx = static_cast<uint32_t>(tiles_x);
  const uint32_t ny = static_cast<uint32_t>(tiles_y);
  const uint32_t side = next_pow2(nx > ny ? nx : ny);
  const uint32_t cells = side * side;
  const uint32_t bits = log2u(cells);
  const bool invert = (mode & 16) != 0;
  const int kind = mode & 15;

  int32_t idx = 0;
  for (uint32_t d = 0; d < cells; ++d) {
    const uint32_t dd = invert ? bit_reverse(d, bits) : d;
    // invert the curve: walk d -> (x, y)
    uint32_t x = 0, y = 0;
    if (kind == 2) {
      // Hilbert d -> xy (inverse walk)
      uint32_t t = dd;
      for (uint32_t s = 1; s < side; s *= 2) {
        uint32_t rx = 1 & (t / 2);
        uint32_t ry = 1 & (t ^ rx);
        if (ry == 0) {
          if (rx == 1) {
            x = s - 1 - x;
            y = s - 1 - y;
          }
          uint32_t tmp = x;
          x = y;
          y = tmp;
        }
        x += s * rx;
        y += s * ry;
        t /= 4;
      }
    } else if (kind == 1) {
      for (int b = 0; b < 16; ++b) {
        x |= ((dd >> (2 * b)) & 1u) << b;
        y |= ((dd >> (2 * b + 1)) & 1u) << b;
      }
    } else {
      x = dd % side;
      y = dd / side;
    }
    if (x < nx && y < ny) {  // skip out-of-image cells (work_queue.cpp:120)
      out[idx++] = static_cast<int32_t>(x + y * nx);
    }
  }
}

// Self-check helpers exposed for tests.
uint32_t mrt_hilbert_d(uint32_t order, uint32_t x, uint32_t y) {
  return hilbert_d(order, x, y);
}
uint32_t mrt_morton_d(uint32_t x, uint32_t y) { return morton_d(x, y); }

}  // extern "C"
