// The KV tiles a flash_attention block visits (flash_attention.cu and
// flash_attention_sm90.cu). Exact skipping: a tile wholly masked for
// every row of the block adds nothing (flash_attention.cu's header), so
// the block visits the tiles from the window's first to the diagonal's
// last. A row whose window lies wholly past the last key keeps no key;
// the reference then averages V over every key, so a block holding such
// a row visits every tile.
#pragma once

// rows [q0, q0 + q_rows) of the query tile, keys in tiles of bn;
// [*lo, *hi] the tiles to visit
__device__ __forceinline__ void flash_kv_tiles(int q0, int q_rows, int skv,
                                               int bn, int causal, int window,
                                               int q_offset, int* lo,
                                               int* hi) {
  const int q_last = q_offset + q0 + q_rows - 1;
  *lo = 0;
  *hi = (skv + bn - 1) / bn - 1;
  if (window <= 0 || q_last - window + 1 <= skv - 1) {
    if (causal) *hi = min(*hi, q_last / bn);
    const int first = q_offset + q0 - window + 1;  // row q0's first key
    if (window > 0 && first > 0) *lo = first / bn;
  }
}
