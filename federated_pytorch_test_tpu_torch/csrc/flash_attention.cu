// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of the JAX package's ops/flash_attention.py
// under its `_flash3` custom VJP. Tensors are f32 and contiguous: q (and
// dO) [BH, Sq, D], k, v [BH, Skv, D], lse and delta [BH, Sq]. Two families:
//
//   aligned causal (Sq = Skv, shift 0; the path of
//   `flash_attention(..., causal=True)`, the LM)
//     _fwd_tri     :559 (_fwd_kernel_tri :253)      -> flash_fwd_launch      -> flash_fwd_tc<D, true> (D 128: fwd128::flash_fwd_d128_tc; one pass at D 16: onepass::flash_fwd_1p_tc)
//     _bwd_tri dq  :655 (_bwd_dq_kernel_tri :341)   -> flash_bwd_dq_launch   -> flash_bwd_dq_tc<D, true> (D 128: dq128::flash_bwd_dq_d128_tc)
//     _bwd_tri dkv :673 (_bwd_dkv_kernel_tri :365)  -> flash_bwd_dkv_launch  -> flash_bwd_dkv_tc<D, true> (D 128: bwd128::flash_bwd_dkv_d128_tc; one pass: onepass::flash_bwd_dkv_1p_tc)
//   rectangular, non-causal or causal on global offsets (q_off, k_off)
//   (the path of `flash_attention(..., causal=False)`, the ViT, and of
//   `flash_block`)
//     _fwd         :601 (_fwd_kernel :395)          -> flash_fwd_rect_launch      -> flash_fwd_tc<D, ·> (D 128, one pass at D 16: the same)
//     _flash3_bwd  :721 (_bwd_dq_kernel :436)       -> flash_bwd_dq_rect_launch   -> flash_bwd_dq_tc<D, ·> (D 128: the same)
//     _flash3_bwd  :744 (_bwd_dkv_kernel :461)      -> flash_bwd_dkv_rect_launch  -> flash_bwd_dkv_tc<D, ·> (D 128, one pass: the same)
//
// o = softmax(q kᵀ·scale [, causal]) v with the natural-log row logsumexp
// lse; dq = scale · Σ_j dS_ij k_j, dv = Σ_i P_ijᵀ dO_i, dk = scale ·
// Σ_i dS_ijᵀ q_i with dS = P ∘ (dO vᵀ − delta), P recomputed from
// (q, k, lse) and delta = rowsum(dO ∘ o) formed by the caller.
//
// Forward: one kernel for both families (`flash_fwd_tc`; at D = 128
// `fwd128::flash_fwd_d128_tc`, below); the aligned forward is the
// rectangular one with Sq = Skv and shift 0.
//   Bound on an H100 SXM. The TPU kernels' dots are f32 at
//   Precision.HIGHEST (several MXU passes). Here each product runs on the
//   tensor cores in split TF32: x = hi + lo with hi = tf32(x) rounded to
//   nearest and lo = x − hi, of which the tensor cores read the TF32 part
//   (they truncate f32 operands), a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b
//   summed in f32 (each operand kept to 2^-21 of itself, no lo·lo term).
//   Three products at 495 TFLOP/s: at the ViT path's shape (BH = 6144, S = 256,
//   D = 16, non-causal: 4.0e8 pairs, 25.8 GFLOP) 0.16 ms, against 0.10 ms
//   for the exps (16 a clock per SM) and 0.12 ms for the bytes; at the LM
//   path's (BH = 128, S = 2048, causal: 2.7e8 pairs) 0.10 ms. An f32 FFMA
//   design is held to 67 TFLOP/s there: 0.385 and 0.257 ms.
//   Design:
//   * A block owns 128 query rows of one (batch·head) as two consumer
//     warpgroups of 64 rows (256 threads). Q is split into hi/lo in shared
//     memory once.
//   * K and V stream in tiles of 64 keys through a ring of two stages
//     filled by cp.async: tile t + 2 is in flight while tiles t and t + 1
//     are computed. After a tile lands the block forms K's hi/lo and Vᵀ's
//     hi/lo in shared memory (TF32 wgmma reads only K-major operands, so V
//     is stored transposed).
//   * S = Q·Kᵀ: three m64n64k8 wgmmas for each 8 columns of D, both
//     operands in shared memory without swizzle (core matrices of 8 rows by
//     16 bytes).
//   * Online softmax on the accumulator fragments: row max over the quad of
//     threads that holds a row, exp2 with log2(e) folded into the scale (one
//     FFMA a score). m starts at the finite −1e30 and masked scores give
//     p = 0 exactly.
//   * P·[V | 1] with P split in registers as the A operand: Vᵀ carries a row
//     of ones, so the row sum l comes out of the tensor cores beside O (as
//     `_augmented_v` :527 does on the TPU) instead of 32 adds a thread and
//     tile. The
//     accumulator gives a thread keys {2t, 2t+1} of every 8 where the TF32 A
//     fragment takes contraction positions {t, t+4}; Vᵀ's keys are permuted
//     the same way in shared memory, so the product is unchanged. Each
//     tile's product sums in a fresh accumulator and joins O and l in FFMAs
//     (·corr + P·[V | 1]): the tensor cores' sums, whose error grows with the
//     terms they add, span one tile and not the whole row.
//   * The instructions each warp runs a tile, not the tensor cores, limit
//     it, so the loop keeps them few: the TF32 rounding is two integer
//     operations (cvt.rna.tf32.f32 lowers to compares and selects), and
//     descriptors are a base plus a constant.
//   * Causal: a block reads keys below `key_end`; a warpgroup skips tiles
//     wholly in its future and masks only tiles across its diagonal; the
//     non-causal instances carry no compare. Causal blocks launch heaviest
//     first.
//   * Each output row is summed by one thread quad in a fixed order: no
//     atomics, bitwise repeatable. A row that saw no key (l = 0) stores
//     o = 0 and lse = −1e30 exactly (`_fwd_kernel` :428-433).
//
// Head dim 128: the 128-row blocks below (`Plan<D>`) would take 397 KB
// (forward), 590 KB (dq) and 460 KB (dk/dv) of shared memory there, past
// the 227 KB a block may have. The forward, dq and dk/dv at D = 128 are
// kernels of their own, below, on blocks of 64 rows; an N = 128 product
// from registers is two m64n64 ones.
//
// The forward at D = 128 is a kernel of its own, `fwd128::flash_fwd_d128_tc`
// (both families, split and one pass). It computes what `flash_fwd_tc`
// computes, at 64 rows a block and 32 keys a tile, in the same order: its
// outputs are those of that plan bit for bit.
//   Bound on an H100 SXM: three TF32 products at 495 TFLOP/s take 0.833 ms
//   at the LM's D-128 shape (BH 128, S 2048, causal) and 0.625 ms at the
//   ViT's (BH 3072, S 256); one pass a third of that, where the bytes
//   (0.482 ms at the ViT's shape) and the exps bound instead. What binds
//   this plan is shared memory: a 64-row warpgroup's m64n32k8 score
//   products read 3 KB of operands every 16 tensor-core clocks, more than
//   the 128 bytes a clock an SM's shared memory gives, and every tile's
//   split operands are written there once (66 KB). Wider tiles do not fit
//   twice: Q's hi and lo take 64 KB and a 32-key stage (K's hi and lo,
//   Vᵀ's hi and lo) 66 KB; with two stages and the mbarriers the plan is
//   201,728 bytes (`Smem<2>`, and 1 KB to align the slabs).
//   Design:
//   * Persistent: a CTA an SM walks the 64-row blocks (`Walk`): a head's
//     blocks side by side, so that its K and V are read from L2 by all of
//     them, heaviest first within the head, dealt out in a snake.
//   * Warp specialised, 256 threads (every one may hold 255 registers, so
//     no setmaxnreg): a producer warpgroup and a consumer warpgroup that
//     meet only on mbarriers (no block-wide barrier in the mainloop).
//   * The producer lands each block's Q by TMA (four 64 x 32-float boxes,
//     128-byte swizzle), rounds it to TF32 in place and writes lo beside it
//     (the next block's Q is prefetched into L2). K and V it reads itself,
//     a tile ahead, into registers, and stores each 32-key tile into a ring
//     of two stages as the consumer reads it: K's hi and lo in the
//     swizzled layout a TMA box lands in (`desc_sw128`), Vᵀ's hi and lo
//     key-permuted as `split_kv` writes them; then it arrives on the
//     stage's `ready` barriers. A TMA-landed V needed a 16 KB buffer that
//     two stages leave room for once, and its latency then stood in every
//     tile (`chip_sweep.py flash_f32`'s loads-only cut: the producer alone
//     took most of the kernel's time).
//   * The consumer only multiplies and exponentiates: it issues tile t's
//     scores with tile t − 1's P·[V | 1 | 0], waits for the scores alone
//     (wgmma.wait_group 1), runs tile t's softmax under that P·V, and frees
//     the stage's K after the scores and its Vᵀ after P·V on the stage's
//     `empty` barriers. Every product group is issued and committed in
//     straight-line code with nothing but wgmmas between its fence and its
//     wait: ptxas serializes every wgmma of a kernel in which a group's
//     registers are touched while another group is open (merging P·V under
//     the next scores did that; `sass … DEPBAR=` in chip_smoke.py's build
//     gate counts the waits).
//   * The same arithmetic as `flash_fwd_tc`: hi = tf32(x) rounded to
//     nearest, lo = x − hi, the three products small ones first (one pass:
//     hi·hi alone), P·[V | 1 | 0] 136 columns wide (an m64n64 and an m64n72
//     product), the online softmax in base 2 with the sign of the scale
//     folded into Q, a fresh accumulator a tile merged into O in FFMAs, a
//     row that sees no key o = 0 and lse = −1e30, causal on global offsets
//     with only the tiles across the diagonal masked (a compile-time
//     branch). No atomics: bitwise repeatable.
//
// dk/dv at D = 128 is a kernel of its own, `bwd128::flash_bwd_dkv_d128_tc`
// (both families, split and one pass). It computes what `flash_bwd_dkv_tc`
// computes, at 64 key rows a block and 16 queries a tile, with the same
// products in the same order (each column's causal partial sum spans one
// tile, as below): its outputs are bit for bit those of that arithmetic
// on one warpgroup.
//   Bound on an H100 SXM: four products, three TF32 passes at 495 TFLOP/s,
//   take 1.667 ms at the LM's D-128 shape (BH 128, S 2048, causal) and 1.249
//   ms at the ViT's (BH 3072, S 256); one pass a third, where the bytes bind
//   the ViT's (0.723 ms). What binds this kernel is shared memory and the
//   Q/dO a tile brings in: on one warpgroup the 96 m64n16k8 score products
//   of a 16-query tile re-read the 64-row K and V (2 KB a k8 step) 192 KB a
//   tile, beside 48 KB for the products and 64 KB of split operands stored,
//   while the tensor cores need 1,536 clocks a tile; 32-query tiles, or a
//   second stage of the transposes beside two of the scores' operands, do
//   not fit 227 KB with K's and V's hi and lo resident (262,400 bytes).
//   Design:
//   * Persistent: a CTA an SM walks the (head, 64-key block)s (`Walk`): a
//     head's blocks side by side, so that its Q and dO tiles are read from
//     L2 by all of them, the first (causal: heaviest) blocks first, dealt out
//     in a snake.
//   * 384 threads: two consumer warpgroups, split by role, and a producer
//     warpgroup (setmaxnreg 48 / 224), meeting on mbarriers and, between
//     the consumers, on named barriers.
//   * Consumer 0 forms Sᵀ = K·Qᵀ, Pᵀ and dv += Pᵀ·dO; consumer 1 dPᵀ = V·dOᵀ,
//     dSᵀ = Pᵀ ∘ (dPᵀ − delta) and dk += dSᵀ·Q, taking each tile's Pᵀ from
//     consumer 0 through shared memory (4 KB a tile, thread to thread).
//     Each holds its own K's (V's) hi in registers as the A fragments of
//     the score products (64 a thread, formed as the block starts) and
//     leaves the lo in shared memory in place of the landed rows, so that
//     two of a score's three passes read only the 512-byte Q (dO) step from
//     shared memory: the consumers read 168 KB a tile instead of 288. The
//     same products in the same order as on one warpgroup (an operand from
//     registers gives the tensor cores the same bits).
//   * The producer lands each block's K and V by TMA into the consumers'
//     rows once their last block's scores are done, and each tile's Q, dO,
//     lse and delta by TMA into a ring of three; it stores a tile's Q and dO
//     hi and lo in the swizzled layout into a ring of two score stages a
//     tile ahead of that tile's Qᵀ and dOᵀ hi and lo (the queries of every
//     8 permuted 0, 2, 4, 6, 1, 3, 5, 7 as `rs_split` reads them) into the
//     one transposes stage: the wgmma takes TF32 operands K-major only, so
//     the products' B operands are stored transposed. The transposes are
//     most of the producer's time (`chip_sweep.py flash_f32`'s cuts).
//   * Each consumer issues tile t's scores, then, once the transposes are
//     stored, tile t − 1's products, waits for the scores alone, forms the
//     tile under those products, and frees the score stage after the scores
//     and the transposes after the products. Every group is issued and
//     committed in straight-line code with nothing but wgmmas between its
//     fence and its wait. The causal instances sum each tile's product in a
//     fresh partial sum added in f32, 64 columns at a time (32 in the split
//     one, whose registers are the tightest); the non-causal ones sum in
//     the accumulator.
//   * A block that sees no query stores dk = dv = 0; the producer lands
//     nothing for it and nobody waits. No atomics: bitwise repeatable.
//
// dq at D = 128 is a kernel of its own, `dq128::flash_bwd_dq_d128_tc` (both
// families, split and one pass). It computes what `flash_bwd_dq_tc`
// computes, at 64 query rows a block and 16 keys a tile, with the same
// products in the same order (each causal tile's dS·K summed apart and
// added in f32): its outputs are bit for bit those of that arithmetic on one
// warpgroup.
//   Bound on an H100 SXM: three products, three TF32 passes at 495 TFLOP/s,
//   take 1.250 ms at the LM's D-128 shape (BH 128, S 2048, causal) and
//   0.937 ms at the ViT's (BH 3072, S 256); one pass a third, where the exps
//   (0.417 ms at the LM's) and the bytes (0.603 ms at the ViT's) bind. On one
//   warpgroup the 96 m64n16k8 score products of a 16-key tile re-read the
//   64-row Q and dO (2 KB a k8 step) 192 KB a tile, beside 48 KB for the
//   tile's other operands and 48 KB of split operands stored, while the
//   tensor cores need ~1,150 clocks a tile.
//   Design (the dk/dv's, mirrored):
//   * Persistent: a CTA an SM walks the (head, 64-row block)s (`Walk`): a
//     head's blocks side by side, so that its K and V tiles are read from L2
//     by all of them, heaviest (causal: the last rows) first, dealt out in a
//     snake.
//   * 384 threads: two consumer warpgroups, split by role, and a producer
//     warpgroup (setmaxnreg: the producer 48, consumer 1 240, consumer 0
//     keeps the 168 of the launch), meeting on mbarriers and, between the
//     consumers, on named barriers.
//   * Consumer 0 forms S = Q·Kᵀ and P = 2^(s·c − lse2), its rows' lse in
//     registers, and hands P to consumer 1 through shared memory (4 KB a
//     tile); consumer 1 forms dP = dO·Vᵀ, dS = P ∘ (dP − delta) and sums
//     dq += dS·K. Each holds its own Q's (dO's) hi in registers as the A
//     fragments of its score product (64 a thread, formed as the block
//     starts) and leaves the lo in shared memory in place of the landed
//     rows: the scores read 64 KB a tile from shared memory instead of 192.
//   * The producer lands each block's Q and dO by TMA into the consumers'
//     rows once their last block's scores are done, and each tile's K and V
//     by TMA into a ring of two; it stores a tile's K and V hi and lo in the
//     swizzled layout into a ring of two score stages. Consumer 0, which has
//     the least to do, copies the tile's K hi and lo from its score stage
//     into Kᵀ's (the keys of every 8 permuted 0, 2, 4, 6, 1, 3, 5, 7 as
//     `rs_split` reads them) in a ring of two transposes stages while its
//     scores run: a producer that also stored the transposes took most of
//     the kernel's time (`chip_sweep.py flash_f32`'s loads-only cut). With
//     one stage consumer 0 would wait for the product of the tile before,
//     which waits for this tile's P; three measured no faster (205,824
//     bytes).
//   * Consumer 1 issues tile t's dP, then tile t − 1's dS·K, waits for dP
//     alone and forms tile t's dS under the product. Every group is issued
//     and committed in straight-line code with nothing but wgmmas between
//     its fence and its wait. The causal instances sum each tile's product
//     in a fresh partial sum of all 128 columns added in f32 (in registers
//     beside dO's hi and dq: 240 a thread, no spill); the non-causal ones sum
//     in the accumulator.
//   * A block that sees no key stores dq = 0; the producer lands nothing for
//     it and nobody waits. No atomics: bitwise repeatable.
//
// Backward, both families: dq (`flash_bwd_dq_tc`) and dk/dv (`flash_bwd_dkv_tc`)
// on the tensor cores, in the forward's split TF32 (lo·hi + hi·lo + hi·hi).
//   Bound on an H100 SXM: dq's three products (S, dP, dS·K) and dk/dv's four
//   (S, dP, Pᵀ·dO, dSᵀ·Q) at 2·D flops a pair each, three TF32 passes at
//   495 TFLOP/s: at the ViT path's 4.0e8 non-causal pairs (BH = 6144,
//   S = 256, D = 16) 0.234 and 0.312 ms, against 0.10 ms for the exps and
//   0.15 and 0.18 ms for the bytes; at the LM path's causal triangle
//   (BH = 128, S = 2048: 2.7e8 pairs) 0.156 and 0.208 ms. An f32 FFMA
//   design is held to 0.577 and 0.769 ms (ViT), 0.385 and 0.513 ms (LM).
//   Design (the forward's building blocks):
//   * A block owns 128 rows as two warpgroups of 64: query rows for dq, key
//     rows for dk/dv. Its own operands (Q and dO; K and V) are split into
//     hi/lo in shared memory once, as the A operands of S = Q·Kᵀ and
//     dP = dO·Vᵀ (Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for dk/dv).
//   * The other side streams through a two-stage cp.async ring: dq in
//     tiles of 64 keys (32 at D = 64, to stay within 227 KB of shared
//     memory), dk/dv in tiles of 32 queries (so that its two split register
//     operands fit in 128 registers together).
//     After a tile lands the block forms its hi/lo in operand layout (the B
//     operands of S and dP) and, of the tile that meets the register
//     operand, its transpose's hi/lo with the rows of every 8 stored as
//     0, 2, 4, 6, 1, 3, 5, 7 (Kᵀ for dq; Qᵀ and dOᵀ for dk/dv).
//   * P = 2^(s·scale·log2 e − lse·log2 e), one FFMA and an exp2 on the
//     accumulator fragments; dS = P ∘ (dP − delta). For dq a thread's two
//     rows carry their lse and delta in registers; for dk/dv the fragment's
//     columns are queries, whose lse and delta are read from shared memory.
//     A row that saw no key (lse = −1e30) carries lse·log2 e = +inf, so its
//     P is exactly 0 without a select.
//   * dS (dq += dS·K), Pᵀ (dv += Pᵀ·dO) and dSᵀ (dk += dSᵀ·Q) are split in
//     registers and fed as the A operand from registers of m64nDk8 wgmmas:
//     the accumulator's columns {2t, 2t+1} of every 8 meet the fragment's
//     positions {t, t+4}, which the transposed operand's order matches.
//     The non-causal instances sum the gradients over every tile in the
//     tensor cores' accumulator. The causal ones, which serve the LM's rows
//     of up to S = 2048 keys or queries, sum each tile's product in a fresh
//     accumulator and add it to the running sum in f32, as the forward does
//     for O. Summed over every tile in the tensor cores, dk and dv drifted
//     from float64 in proportion to S (up to 3.1e-5 of the largest entry at
//     S = 2048, 5.7e-5 at 4096, on an H100) and moved the LM's L-BFGS steps
//     by 1.8e-3; tile by tile they stay within 1e-6. There dk/dv issues its
//     two products one after the other, so that one partial sum and one
//     split operand are live at a time.
//   * Causal: a block reads only the tiles that can see it (`key_end` for
//     dq, from `qt0` for dk/dv); a warpgroup skips tiles wholly outside its
//     triangle and masks, by select, only tiles across its diagonal. Causal
//     blocks launch heaviest first: late query blocks for dq, early key
//     blocks for dk/dv.
//   * Each output row is summed by one warpgroup in a fixed order: no
//     atomics, bitwise repeatable.
//
// The aligned causal backward is the same two kernels at Sq = Skv and
// shift 0, as the aligned forward is `flash_fwd_tc` at shift 0.
//
// One pass (`passes` = 1): the path of `precision='default'` on f32
// inputs. The TPU's Precision.DEFAULT runs each dot as one bf16 MXU pass;
// its counterpart here is one TF32 product a product, hi·hi with both
// operands rounded by `tf32()` — not a block-by-block carry-over of the TPU
// kernels. TF32 keeps 10 mantissa bits against bf16's 8, inside the JAX
// package's 'default' contract (2e-2 from f32, tests/test_flash.py). The
// forward at D = 16 is a kernel of its own, `onepass::flash_fwd_1p_tc`;
// above it the forward and the dq are `flash_fwd_tc` and `flash_bwd_dq_tc`
// (fwd128, dq128 at D = 128) compiled without the lo operands and the lo·hi,
// hi·lo products, tiles and shared memory unchanged; dk/dv is bwd128's at
// D = 128 and up to D = 64 a kernel of its own,
// `onepass::flash_bwd_dkv_1p_tc`, which sums in the order of the split
// `flash_bwd_dkv_tc`.
//   The forward at D = 16 computes what `flash_fwd_tc<16, ·, false>`
//   computes, with the same products in the same order (64-key tiles, the
//   running max, the TF32 rounding of P, a fresh P·[V | 1 | 0] a tile merged
//   in FFMAs): its outputs are that kernel's bit for bit.
//   Bound on an H100 SXM: at the ViT's shape (BH 6144, S 256, D 16, 4.0e8
//   pairs) the bytes (q, k, v, o 100.7 MB each, lse 6.3 MB) take 0.122 ms,
//   the exps ~0.10 and the one TF32 pass ~0.06; at the LM's causal triangle
//   (BH 128, S 2048) the exps, 0.069. What held `flash_fwd_tc` back
//   (`chip_sweep.py flash_1p`'s cuts of it): its products, each waited for
//   by both warpgroups between block barriers, cost 0.11 of its 0.28 ms at
//   the ViT's shape, and its data side alone (a synchronous Q prologue,
//   every thread staging K and V between two block barriers, each head's K
//   and V landed and rounded twice) 0.60 of the whole. The forward's design:
//   * Persistent, a CTA an SM, 640 threads: blocks of 256 query rows walked
//     as `Walk` (a head's blocks side by side; causal, its last rows first;
//     in a snake). A block is the ViT's whole head, so each K/V tile is
//     landed and rounded once a head. A head's last block may hold 128 rows;
//     warpgroups 2 and 3 then only free the stages.
//   * Four consumer warpgroups of 64 rows meet the producer on mbarriers and
//     never each other. Each holds its rows' Q hi in registers as the A
//     operand of the scores (rounded from the landed Q as a block starts, 8
//     a thread: no synchronous prologue) and runs a tile at a time. Its
//     index is broadcast from lane 0, so that ptxas keeps the stage addresses
//     and descriptors in uniform registers (computed per thread, each
//     descriptor was moved to a uniform register before every HGMMA: 5% of
//     the kernel's time). A block's first scores are issued before the last
//     block's o and lse are stored and waited for after; each tile's scores
//     are an array of their own (one array carried over the loop made ptxas
//     serialize every wgmma). P's TF32 hi is its bits plus half a unit of
//     the 13 dropped bits, unmasked: the tensor cores read a TF32 operand
//     truncated, so the bits are tf32(p)'s and 32 integer operations a tile
//     go.
//   * The producer warpgroup is four warps that never wait for each other:
//     warp w lands keys 16w … 16w + 15 of every K/V tile by bulk copy four
//     tiles ahead, and a block ahead the Q rows of consumer warpgroup w; it
//     stores its quarter of each tile's operands (K's hi in operand layout,
//     Vᵀ's hi with the keys of every 8 permuted 0, 2, 4, 6, 1, 3, 5, 7, the
//     [1 | 0] rows written once) into a ring of eight stages.
//   * What binds it is the consumers (the cuts: the producer alone takes
//     about half the time, the consumers alone nearly all of it). On an SM
//     the TF32 wgmmas and the ex2s took the sum of their times, not the
//     larger (a probe, PERF.md). Issuing a tile's scores with the last
//     tile's P·V (as fwd128 does), taking the exps in turns on named
//     barriers, deeper rings and fewer proxy fences all measured no faster.
//   * Causal as `flash_fwd_tc`: a warpgroup computes the tiles up to its
//     diagonal and masks only those across it; a row that sees no key stores
//     o = 0 and lse = −1e30; a block no row of which sees a key lands
//     nothing. No atomics: bitwise repeatable.
//   The dk/dv, bound on an H100 SXM: with one TF32 pass the products no
//   longer bind. At the ViT's shape (BH 6144, S 256, D 16) its bytes take 0.184 ms,
//   its four products ~0.10 and its exps 0.10; at the LM's causal triangle
//   (BH 128, S 2048) the exps, 0.069 (chip_smoke.py computes each). At S
//   256 a 128-key block has 8 query tiles: too few to hide a CTA's
//   prologue, and staging by every thread between block barriers (as
//   `flash_bwd_dkv_tc` does) puts loads, staging and products one after
//   another. dk/dv's design:
//   * Persistent: kCtas CTAs an SM (`DkvPlan`: two at D = 16, one above)
//     walk the 128-key blocks (`Walk`): a head's blocks side by side, the
//     causal first keys first, dealt out in a snake, so that a head's Q and
//     dO are read from L2 by its blocks together.
//   * Warp specialised, 384 threads: two consumer warpgroups of 64 key rows
//     and a producer warpgroup (setmaxnreg), meeting on mbarriers; no
//     block-wide barrier. The producer lands each block's K and V by bulk
//     copy a block ahead, and each query tile (Q, dO, lse, delta) by
//     cp.async, several tiles ahead, into raw stages; it rounds each landed
//     element once and stores Q's and dO's hi, their query-permuted
//     transposes, lse2 and delta into a ring of kRing stages. A producer
//     chain takes ~1 µs a tile whatever the tile's bytes, so below D = 64
//     it runs in two chains that take the tiles in turn (kChains).
//   * Each consumer warpgroup rounds its block's K and V rows into its own
//     operand as the block starts, then only multiplies and exponentiates,
//     a tile at a time, summing in flash_bwd_dkv_tc's order. Overlapping a
//     tile's products with the next one's exps needs ~110 registers a
//     consumer, which two CTAs an SM do not have; at one CTA an SM the
//     overlap measured slower than two CTAs without it.
//   * Causal: a warpgroup frees the tiles wholly before its keys unread and
//     masks only those across its diagonal; a block no query sees stores dk
//     = dv = 0, and the producer lands nothing for it. No atomics: bitwise
//     repeatable.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_tma.cuh"
#include "tf32_wgmma.cuh"

namespace {

constexpr int kBlock = 128;  // S (queries and keys) must be a multiple: the rows of the largest block

bool shape_ok(int bh, int s) { return bh >= 1 && bh <= 65535 && s >= kBlock && s % kBlock == 0; }

// ---------------------------------------------------------------------------
// The rectangular family: q [BH, Sq, D] against k, v [BH, Skv, D], either
// non-causal (every query sees every key) or causal on global positions:
// query row i sits at q_off + i, key row j at k_off + j, and the pair is
// kept iff k_off + j <= q_off + i, i.e. j <= i + shift with
// shift = q_off − k_off. A row may then see no key at all (a block in its
// future, or an unaligned shift); it gets o = 0, lse = −1e30 and P = 0 in
// the backward, as the TPU kernels' masked-row guards give.
// ---------------------------------------------------------------------------

// keys [0, kend) can be seen by a query block whose last row is row0 + Rows − 1
template <int Rows>
__device__ __forceinline__ int key_end(int row0, int shift, int s_kv) {
  return min(max(row0 + Rows + shift, 0), s_kv);
}

bool rect_shape_ok(int bh, int s_q, int s_kv) { return shape_ok(bh, s_q) && shape_ok(bh, s_kv); }

// ---------------------------------------------------------------------------
// The tensor-core kernels: the forward and the backward of both families
// (see the notes at the top).
// ---------------------------------------------------------------------------
namespace tc {

using namespace tf32_wgmma;

// A block's plan by head dim up to 64 (D = 128 runs kernels of its own: the
// note at the top); the sizes stand in the static_asserts below each
// shared-memory struct.
template <int D>
struct Plan {
  static_assert(D <= 64, "D = 128 runs fwd128, dq128 and bwd128");
  static constexpr int kRows = 128;     // rows a block owns: two warpgroups of 64
  static constexpr int kThreads = 256;
  static constexpr int kKeys = 64;      // keys a forward K/V tile
  // rows of the streamed operand a backward tile. dq streams 64 keys, 32
  // at D = 64, where more would take the block past the 227 KB of shared
  // memory it can have. dk/dv streams 32 queries: then its two products'
  // split register operands (2 · 32 registers) fit beside the accumulators
  // in the 128 registers of two blocks an SM, and are issued together.
  static constexpr int kDqTile = D == 64 ? 32 : 64;
  static constexpr int kDkvTile = 32;
};
constexpr int kStages = 2;  // depth of the streamed tiles' ring
// attribution cuts (the template argument Cut of the forwards and of the
// one-pass dk/dv, chip_sweep.py flash_f32 and flash_1p, built with
// -DFLASH_F32_CUTS; the shipped entry points take kFull)
constexpr int kFull = 0, kNoExp = 1, kNoMma = 2, kLoadsOnly = 3, kNoSplit = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x; results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// P·[V | 1 | 0]: the D + 8 columns of Vᵀ's operand (see Smem). At D = 128
// the 136 columns are an m64n64 and an m64n72 product, on Vᵀ's rows 0 … 63
// and 64 … 135 (row 64 lies 1 KB, 64 descriptor units, past row 0).
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[(D + 8) / 2], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (D == 16) {
    wgmma_rs_n24(d, a, b, accumulate);
  } else if constexpr (D == 32) {
    wgmma_rs_n40(d, a, b, accumulate);
  } else if constexpr (D == 64) {
    wgmma_rs_n72(d, a, b, accumulate);
  } else {
    static_assert(D == 128, "no P·V product of this head dim");
    wgmma_rs_n64(cols<64>(d, 0), a, b, accumulate);
    wgmma_rs_n72(cols<72>(d, 64), a, b + 64, accumulate);
  }
}

template <int D>
struct Smem {
  static constexpr int R = Plan<D>::kRows, T = Plan<D>::kKeys;
  float q_hi[R * D], q_lo[R * D];  // per warpgroup a 64-row operand
  float raw[kStages][2][T * D];    // landed tiles: K (operand layout) and V (row-major)
  float k_hi[T * D], k_lo[T * D];  // operand layout, T rows (keys) by D
  // Vᵀ: D + 8 rows by T permuted keys; rows D … D + 7 hold [1 | 0] (ones in
  // row D of hi), so that P·V's column D is P's row sum
  float vt_hi[(D + 8) * T], vt_lo[(D + 8) * T];
};
static_assert(sizeof(Smem<64>) <= 232448, "over 227 KB of shared memory");

template <int D>
constexpr int kTileChunks = Plan<D>::kKeys * D / 4 / Plan<D>::kThreads;  // 16-byte chunks of a K or V tile a thread moves

// cp.async of keys [kt, kt + T) of K and V into ring stage `st`
template <int D>
__device__ __forceinline__ void load_kv(Smem<D>& sm, int st, const float* kb, const float* vb, int kt) {
  const float* kt_b = kb + (size_t)kt * D;
  const float* vt_b = vb + (size_t)kt * D;
#pragma unroll
  for (int n = 0; n < kTileChunks<D>; ++n) {
    const unsigned i = threadIdx.x + n * Plan<D>::kThreads;  // chunk i: row i / (D/4), columns 4·(i % (D/4)) + 0..3
    cp_async16(&sm.raw[st][0][cidx<Plan<D>::kKeys>(i / (D / 4), i % (D / 4) * 4)], kt_b + 4 * i);
    cp_async16(&sm.raw[st][1][4 * i], vt_b + 4 * i);
  }
}

// The landed stage `st` into the split operands: K's hi/lo at the same
// operand-layout index, and Vᵀ's hi/lo with the keys of every 8 in the order
// 0, 2, 4, 6, 1, 3, 5, 7 (contraction position t holds key 2t, t + 4 key 2t + 1).
// One pass (Split false) forms hi alone.
template <int D, bool Split>
__device__ __forceinline__ void split_kv(Smem<D>& sm, int st) {
  const float4* kr = reinterpret_cast<const float4*>(sm.raw[st][0]);
#pragma unroll
  for (int n = 0; n < kTileChunks<D>; ++n) {
    const unsigned i = threadIdx.x + n * Plan<D>::kThreads;
    float4 hi, lo;
    split4(kr[i], hi, lo);
    reinterpret_cast<float4*>(sm.k_hi)[i] = hi;
    if constexpr (Split) reinterpret_cast<float4*>(sm.k_lo)[i] = lo;
  }
  const float* vr = sm.raw[st][1];
#pragma unroll
  for (int n = 0; n < kTileChunks<D>; ++n) {
    const unsigned i = threadIdx.x + n * Plan<D>::kThreads;
    const unsigned d = i % D, pg = i / D;          // positions 4pg … 4pg + 3 of Vᵀ's row d
    const unsigned key0 = (pg >> 1) * 8 + (pg & 1);  // hold keys key0 + 0, 2, 4, 6
    float4 x = make_float4(vr[key0 * D + d], vr[(key0 + 2) * D + d], vr[(key0 + 4) * D + d],
                           vr[(key0 + 6) * D + d]);
    float4 hi, lo;
    split4(x, hi, lo);
    const unsigned at = cidx<D + 8>(d, 4 * pg);
    *reinterpret_cast<float4*>(&sm.vt_hi[at]) = hi;
    if constexpr (Split) *reinterpret_cast<float4*>(&sm.vt_lo[at]) = lo;
  }
}

// x's TF32 hi and, with Split, the rest lo, in registers (pinned: the
// wgmmas read them)
template <int N, bool Split>
__device__ __forceinline__ void split_frag(const float (&x)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = tf32(x[i]);
    if constexpr (Split) lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
  }
  pin(hi);
  if constexpr (Split) pin(lo);
}

// Forward of q [BH, Sq, D] against k, v [BH, Skv, D] for D up to 64 (D =
// 128: fwd128::flash_fwd_d128_tc, the same arithmetic); causal keeps the
// pair (i, j) iff j <= i + shift. Split: three TF32 products a product (f32
// accuracy, the TPU's 'highest'); else one, hi·hi (the TPU's 'default'),
// at D = 32 and 64 only: the one-pass forward at D = 16 runs
// onepass::flash_fwd_1p_tc. Grid (Sq / kRows, BH), kThreads threads
// (`Plan<D>`), sizeof(Smem<D>) bytes of dynamic shared memory; two blocks
// an SM up to D = 32 (at most 128 registers a thread). Cut: an attribution
// cut (kFull shipped; the others only in the -DFLASH_F32_CUTS library,
// `flash_fwd_tc_cut_launch`, chip_sweep.py flash_1p): no exps; no products
// (scores that differ by element); loads only (K and V landed and split,
// nothing computed); no split (nothing landed or split: the products and
// exps alone, the block barriers kept).
template <int D, bool Causal, bool Split, int Cut = kFull>
__global__ void __launch_bounds__(Plan<D>::kThreads, D >= 64 ? 1 : 2)
flash_fwd_tc(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
             float* __restrict__ o, float* __restrict__ lse, int s_q, int s_kv, int shift, float scale) {
  constexpr int kRows = Plan<D>::kRows, kThreads = Plan<D>::kThreads, kKeys = Plan<D>::kKeys;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_bytes);
  const int bh = blockIdx.y;
  const int row0 = (Causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;  // causal: heaviest first
  const float* kb = k + (size_t)bh * s_kv * D;
  const float* vb = v + (size_t)bh * s_kv * D;
  const int kend = Causal ? key_end<kRows>(row0, shift, s_kv) : s_kv;
  const int n_tiles = (kend + kKeys - 1) / kKeys;  // tiles past s_kv are never read: s_kv % kBlock == 0

#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (Cut != kNoSplit && st < n_tiles) load_kv<D>(sm, st, kb, vb, st * kKeys);
    cp_async_commit();
  }
  // Q's hi/lo, its sign folded in so that the kernel scales by |scale|
  const float sgn = scale < 0.f ? -1.f : 1.f;
  const float4* qb = reinterpret_cast<const float4*>(q + ((size_t)bh * s_q + row0) * D);
#pragma unroll
  for (int n = 0; n < kRows * D / 4 / kThreads; ++n) {
    const unsigned i = threadIdx.x + n * kThreads, r = i / (D / 4);
    float4 x = __ldg(qb + i), hi, lo;
    x = make_float4(sgn * x.x, sgn * x.y, sgn * x.z, sgn * x.w);
    split4(x, hi, lo);
    const unsigned at = r / 64 * 64 * D + cidx<64>(r % 64, i % (D / 4) * 4);
    *reinterpret_cast<float4*>(&sm.q_hi[at]) = hi;
    if constexpr (Split) *reinterpret_cast<float4*>(&sm.q_lo[at]) = lo;
  }
  for (unsigned i = threadIdx.x; i < 8 * kKeys; i += kThreads) {  // Vᵀ's rows D … D + 7
    const unsigned r = D + i / kKeys, at = cidx<D + 8>(r, i % kKeys);
    sm.vt_hi[at] = r == D ? 1.f : 0.f;
    sm.vt_lo[at] = 0.f;
  }
  proxy_fence();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = row0 + 64 * wg;                     // this warpgroup's first query row
  const int row_a = wrow0 + 16 * warp + g, row_b = row_a + 8;  // the two rows this thread holds
  // descriptor bases: shared address / 16 of the block's shared memory, and of this warpgroup's Q rows
  const uint32_t base16 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bytes)) >> 4;
  const uint32_t q16 = base16 + 64 * D * 4 / 16 * wg;
  using S = Smem<D>;
  const float c = fabsf(scale) * kLog2e;  // p = 2^(s·c − m): m is in units of log2

  float acc[(D + 8) / 2];  // O and, in column D, the row sum l
#pragma unroll
  for (int i = 0; i < (D + 8) / 2; ++i) acc[i] = 0.f;
  float m_a = -1e30f, m_b = -1e30f;  // finite: m − m_new is never inf − inf

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 1>();  // this thread's copies of tile `it` have landed
    __syncthreads();               // everyone's; and the last tile's wgmmas are done
    if constexpr (Cut != kNoSplit) split_kv<D, Split>(sm, it % kStages);
    proxy_fence();
    __syncthreads();
    if (Cut != kNoSplit && it + kStages < n_tiles) load_kv<D>(sm, it % kStages, kb, vb, (it + kStages) * kKeys);
    cp_async_commit();

    const int kt = it * kKeys;
    if (Cut == kLoadsOnly || (Causal && kt > wrow0 + 63 + shift)) continue;  // wholly in this warpgroup's future

    // S = Q·Kᵀ, small products first. s[4j + e] is (row_a, key kt + 8j + 2t + e),
    // s[4j + 2 + e] the same key on row_b.
    float s[kKeys / 2];
    if constexpr (Cut == kNoMma) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.03125f * i;
    } else {
      wg_fence();
      if constexpr (Split) {
#pragma unroll
        for (int ks = 0; ks < D / 8; ++ks) {
          const uint32_t at = 32 * 64 * ks, kat = 32 * kKeys * ks;  // bytes to columns 8ks … 8ks + 7 of Q, K
          wgmma_ss<kKeys>(s, desc<64>(q16, offsetof(S, q_lo) + at), desc<kKeys>(base16, offsetof(S, k_hi) + kat),
                          ks > 0);
          wgmma_ss<kKeys>(s, desc<64>(q16, offsetof(S, q_hi) + at), desc<kKeys>(base16, offsetof(S, k_lo) + kat), 1);
        }
      }
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks)
        wgmma_ss<kKeys>(s, desc<64>(q16, offsetof(S, q_hi) + 32 * 64 * ks),
                        desc<kKeys>(base16, offsetof(S, k_hi) + 32 * kKeys * ks), Split || ks > 0);
      wg_commit();
      wg_wait();
      pin(s);
    }

    const bool mask = Causal && kt + kKeys - 1 > wrow0 + shift;  // the tile crosses the diagonal
    if (mask) {
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt + 8 * j + 2 * t + e;
          if (key > row_a + shift) s[4 * j + e] = -INFINITY;
          if (key > row_b + shift) s[4 * j + 2 + e] = -INFINITY;
        }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * c), mn_b = fmaxf(m_b, mx_b * c);  // fmaxf drops a NaN
    const float corr_a = Cut == kNoExp ? 1.f : exp2_ftz(m_a - mn_a), corr_b = Cut == kNoExp ? 1.f : exp2_ftz(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pa = fmaf(s[4 * j + e], c, -mn_a), pb = fmaf(s[4 * j + 2 + e], c, -mn_b);
        if constexpr (Cut != kNoExp) {
          pa = exp2_ftz(pa);
          pb = exp2_ftz(pb);
        }
        if (mask) {  // exactly 0, whatever the scale
          pa = s[4 * j + e] == -INFINITY ? 0.f : pa;
          pb = s[4 * j + 2 + e] == -INFINITY ? 0.f : pb;
        }
        s[4 * j + e] = pa;
        s[4 * j + 2 + e] = pb;
      }

    // The tile's P·[V | 1] into a fresh accumulator, small products first,
    // then O = O·corr + P·V (and l = l·corr + Σ P) in FFMAs: the tensor
    // cores' own sums then span one tile, not the whole row (their rounding
    // grows with the terms they add).
    // The A fragment of keys 8j … 8j + 7 is (row_a, pos t), (row_b, pos t),
    // (row_a, pos t + 4), (row_b, pos t + 4).
    uint32_t ph[kKeys / 2], pl[kKeys / 2];
    split_frag<kKeys / 2, Split>(s, ph, pl);
    float pv[(D + 8) / 2];
    if constexpr (Cut == kNoMma) {
#pragma unroll
      for (int i = 0; i < (D + 8) / 2; ++i) pv[i] = __uint_as_float(ph[i % (kKeys / 2)]);
    } else {
      wg_fence();
      if constexpr (Split) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          const uint32_t a_lo[4] = {pl[4 * j], pl[4 * j + 2], pl[4 * j + 1], pl[4 * j + 3]};
          const uint32_t a_hi[4] = {ph[4 * j], ph[4 * j + 2], ph[4 * j + 1], ph[4 * j + 3]};
          wgmma_pv<D>(pv, a_lo, desc<D + 8>(base16, offsetof(S, vt_hi) + 32 * (D + 8) * j), j > 0);
          wgmma_pv<D>(pv, a_hi, desc<D + 8>(base16, offsetof(S, vt_lo) + 32 * (D + 8) * j), 1);
        }
      }
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        const uint32_t a_hi[4] = {ph[4 * j], ph[4 * j + 2], ph[4 * j + 1], ph[4 * j + 3]};
        wgmma_pv<D>(pv, a_hi, desc<D + 8>(base16, offsetof(S, vt_hi) + 32 * (D + 8) * j), Split || j > 0);
      }
      wg_commit();
      wg_wait();
      pin(pv);
    }
#pragma unroll
    for (int j = 0; j < (D + 8) / 8; ++j) {
      acc[4 * j] = fmaf(acc[4 * j], corr_a, pv[4 * j]);
      acc[4 * j + 1] = fmaf(acc[4 * j + 1], corr_a, pv[4 * j + 1]);
      acc[4 * j + 2] = fmaf(acc[4 * j + 2], corr_b, pv[4 * j + 2]);
      acc[4 * j + 3] = fmaf(acc[4 * j + 3], corr_b, pv[4 * j + 3]);
    }
  }

  // l: column D, held by the quad's thread t = 0
  const float l_a = __shfl_sync(0xffffffffu, acc[D / 2], lane & ~3);
  const float l_b = __shfl_sync(0xffffffffu, acc[D / 2 + 2], lane & ~3);
  // masked-row guard: a row that saw no key has l == 0 and acc == 0
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f, inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  float* oa = o + ((size_t)bh * s_q + row_a) * D + 2 * t;
  float* ob = o + ((size_t)bh * s_q + row_b) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(oa + 8 * j) = make_float2(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
    *reinterpret_cast<float2*>(ob + 8 * j) = make_float2(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
  }
  if (t == 0) {
    lse[(size_t)bh * s_q + row_a] = l_a > 0.f ? fmaf(m_a, kLn2, logf(l_a)) : -1e30f;
    lse[(size_t)bh * s_q + row_b] = l_b > 0.f ? fmaf(m_b, kLn2, logf(l_b)) : -1e30f;
  }
}

// Online softmax of a tile of Keys keys from key kt, in place, as
// flash_fwd_tc does it: s[4j + e] is (row_a, key kt + 8j + 2t + e),
// s[4j + 2 + e] the same key on row_b. Masked: the tile crosses these rows'
// diagonal (a compile-time branch).
template <int Keys, bool Masked, int Cut>
__device__ __forceinline__ void softmax_tile(float (&s)[Keys / 2], int kt, int row_a, int row_b, int shift, int t,
                                             float c, float& m_a, float& m_b, float& corr_a, float& corr_b) {
  if constexpr (Masked) {
#pragma unroll
    for (int j = 0; j < Keys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kt + 8 * j + 2 * t + e;
        if (key > row_a + shift) s[4 * j + e] = -INFINITY;
        if (key > row_b + shift) s[4 * j + 2 + e] = -INFINITY;
      }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < Keys / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a * c), mn_b = fmaxf(m_b, mx_b * c);  // fmaxf drops a NaN
  corr_a = Cut == kNoExp ? 1.f : exp2_ftz(m_a - mn_a);
  corr_b = Cut == kNoExp ? 1.f : exp2_ftz(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
#pragma unroll
  for (int j = 0; j < Keys / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float pa = fmaf(s[4 * j + e], c, -mn_a), pb = fmaf(s[4 * j + 2 + e], c, -mn_b);
      if constexpr (Cut != kNoExp) {
        pa = exp2_ftz(pa);
        pb = exp2_ftz(pb);
      }
      if constexpr (Masked) {  // exactly 0, whatever the scale
        pa = s[4 * j + e] == -INFINITY ? 0.f : pa;
        pb = s[4 * j + 2 + e] == -INFINITY ? 0.f : pb;
      }
      s[4 * j + e] = pa;
      s[4 * j + 2 + e] = pb;
    }
}

// ---------------------------------------------------------------------------
// The forward at head dim 128 (the note at the top: head dim 128)
// ---------------------------------------------------------------------------
namespace fwd128 {

using hopper_tma::aligned_smem;
using hopper_tma::bar_arrive;
using hopper_tma::bar_expect;
using hopper_tma::bar_init;
using hopper_tma::bar_wait;
using hopper_tma::smem_u32;
using hopper_tma::tma_box;
using hopper_tma::tma_prefetch;

constexpr int kD = 128;
constexpr int kKeys = 32;           // keys a K/V tile (F32_FWD_KEYS[128] in ops/flash_cuda.py)
constexpr int kRows = 64;           // query rows a block owns: one consumer warpgroup
constexpr int kThreads = 256;       // the consumer warpgroup, then the producer warpgroup
constexpr int kSlab = 32;           // floats a swizzled row (128 bytes): the columns of a slab
constexpr int kSlabs = kD / kSlab;
constexpr int kVt = kD + 8;         // Vᵀ's rows: D, then [1 | 0]
constexpr int kChunks = kKeys * kD / 4 / 128;  // 16-byte chunks of a K tile a producer thread moves
constexpr int kSmemLimit = 232448;  // shared memory a block may have
constexpr int kRegisters = 65536;   // registers of an SM
static_assert(kThreads * 255 <= kRegisters, "every thread may hold 255 registers: no setmaxnreg needed");

// The operands of a tile of 32 keys: K's hi and lo as four slabs of 32
// keys by 32 floats with the 128-byte swizzle (the layout a TMA box of 32
// columns lands in, read with `desc_sw128`), and Vᵀ's hi and lo with the
// keys of every 8 in the order 0, 2, 4, 6, 1, 3, 5, 7 (`cidx<kVt>`, rows
// D … D + 7 [1 | 0]).
struct Stage {
  float k[kKeys * kD];
  float k_lo[kKeys * kD];
  float vt_hi[kVt * kKeys], vt_lo[kVt * kKeys];
};
static_assert(sizeof(Stage) == 67584 && sizeof(Stage) % 1024 == 0, "a stage keeps its slabs 1 KB aligned");

template <int Ring>
struct Smem {
  alignas(1024) float q[kRows * kD];     // Q as the TMA landed it (four slabs of 64 rows by 32 floats), rounded in place
  alignas(1024) float q_lo[kRows * kD];  // Q − hi at the same offsets
  alignas(1024) Stage st[Ring];
  uint64_t q_land, q_ready, q_empty;
  uint64_t k_ready[Ring], k_empty[Ring], v_ready[Ring], v_empty[Ring];
};
// The plans' bytes (the launch asks for 1 KB more, to align the slabs):
// two operand stages (shipped), one (chip_sweep.py flash_f32). A third
// stage does not fit.
static_assert(sizeof(Smem<2>) == 201728 && sizeof(Smem<2>) + 1024 <= kSmemLimit, "two stages over 227 KB");
static_assert(sizeof(Smem<1>) == 134144 && sizeof(Smem<1>) + 1024 <= kSmemLimit, "one stage over 227 KB");
static_assert(sizeof(Smem<2>) + sizeof(Stage) + 1024 > kSmemLimit, "a third stage would fit");

// The blocks of a launch in the order the persistent CTAs take them: a
// head's blocks side by side, so that its K and V are read from L2 by all
// of them while they run, and within a head heaviest first (causal: the
// last rows first), dealt out in a snake — CTA c takes c, 2G − 1 − c,
// 2G + c, … of G CTAs — so that the causal blocks' uneven work evens out.
struct Walk {
  int heads, blocks;  // BH, and blocks a head
  // this CTA's n-th block: head bh, position r in the head's order; false past the last
  __device__ __forceinline__ bool next(int n, int& bh, int& r) const {
    const int g = gridDim.x, c = blockIdx.x;
    const int idx = n * g + (n % 2 == 0 ? c : g - 1 - c);
    if (idx >= heads * blocks) return false;
    bh = idx / blocks;
    r = idx % blocks;
    return true;
  }
};

// S = Q·Kᵀ over D into s, flash_fwd_tc's products in its order (small ones
// first; one pass: hi·hi): q and k are the descriptors of the Q rows' and
// the K tile's first slab (hi; lo q_lo, k_lo bytes past them); k8 step ks
// lies in slab ks / 4, 32·(ks % 4) bytes into its rows.
template <bool Split>
__device__ __forceinline__ void issue_scores(float (&s)[kKeys / 2], uint64_t q, uint64_t k, uint32_t q_lo,
                                             uint32_t k_lo) {
  constexpr uint32_t kSlabQ = kRows * 128, kSlabK = kKeys * 128;  // bytes of a slab
  if constexpr (Split) {
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) {
      const uint32_t qo = (ks / 4 * kSlabQ + 32 * (ks % 4)) >> 4, ko = (ks / 4 * kSlabK + 32 * (ks % 4)) >> 4;
      wgmma_ss<kKeys>(s, q + qo + (q_lo >> 4), k + ko, ks > 0);
      wgmma_ss<kKeys>(s, q + qo, k + ko + (k_lo >> 4), 1);
    }
  }
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks) {
    const uint32_t qo = (ks / 4 * kSlabQ + 32 * (ks % 4)) >> 4, ko = (ks / 4 * kSlabK + 32 * (ks % 4)) >> 4;
    wgmma_ss<kKeys>(s, q + qo, k + ko, Split || ks > 0);
  }
}

// pv = P·[V | 1 | 0] of the tile, flash_fwd_tc's products in its order
// (small ones first; one pass: hi·hi), P split in registers as the A
// operand, Vᵀ's hi at descriptor base vt16 (lo vt_lo bytes past it)
template <bool Split>
__device__ __forceinline__ void issue_pv(float (&pv)[(kD + 8) / 2], const uint32_t (&ph)[kKeys / 2],
                                         const uint32_t (&pl)[kKeys / 2], uint32_t vt16, uint32_t vt_lo) {
  if constexpr (Split) {
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      const uint32_t a_lo[4] = {pl[4 * j], pl[4 * j + 2], pl[4 * j + 1], pl[4 * j + 3]};
      const uint32_t a_hi[4] = {ph[4 * j], ph[4 * j + 2], ph[4 * j + 1], ph[4 * j + 3]};
      wgmma_pv<kD>(pv, a_lo, desc<kVt>(vt16, 32 * kVt * j), j > 0);
      wgmma_pv<kD>(pv, a_hi, desc<kVt>(vt16, vt_lo + 32 * kVt * j), 1);
    }
  }
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    const uint32_t a_hi[4] = {ph[4 * j], ph[4 * j + 2], ph[4 * j + 1], ph[4 * j + 3]};
    wgmma_pv<kD>(pv, a_hi, desc<kVt>(vt16, 32 * kVt * j), Split || j > 0);
  }
}

// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Forward of q [BH, Sq, 128] against k, v [BH, Skv, 128] as flash_fwd_tc
// computes it, for Hopper (the note at the top). Persistent: grid
// min(SMs, blocks), kThreads threads, sizeof(Smem<Ring>) + 1024 bytes of
// dynamic shared memory; q through a TMA map of [BH·Sq, 128] f32 in boxes
// of 32 columns by 64 rows, k and v read by the producer's threads.
template <bool Causal, bool Split, int Ring, int Cut = kFull>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_d128_tc(const __grid_constant__ CUtensorMap map_q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int bh_count,
                  int s_q, int s_kv, int shift, float scale) {
  using S = Smem<Ring>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = aligned_smem<S>(smem_raw);
  const Walk walk{bh_count, s_q / kRows};

  if (threadIdx.x == 0) {
    bar_init(&sm.q_land, 1);     // the issuing thread's bar_expect; then the bytes
    bar_init(&sm.q_ready, 128);  // every producer thread, after its part of the operands
    bar_init(&sm.q_empty, 4);    // a consumer warp each
    for (int i = 0; i < Ring; ++i) {
      bar_init(&sm.k_ready[i], 128);
      bar_init(&sm.k_empty[i], 4);
      bar_init(&sm.v_ready[i], 128);
      bar_init(&sm.v_empty[i], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (unsigned i = threadIdx.x; i < Ring * 8 * kKeys; i += kThreads) {  // Vᵀ's rows D … D + 7 of every stage
    const unsigned r = kD + i % (8 * kKeys) / kKeys, at = cidx<kVt>(r, i % kKeys);
    sm.st[i / (8 * kKeys)].vt_hi[at] = r == kD ? 1.f : 0.f;
    sm.st[i / (8 * kKeys)].vt_lo[at] = 0.f;
  }
  proxy_fence();
  __syncthreads();

  // a block's first row and its K/V tiles (keys [0, kend) can be seen by its rows)
  auto block_row0 = [&](int r) { return (Causal ? walk.blocks - 1 - r : r) * kRows; };
  auto tiles_of = [&](int row0) {
    return ((Causal ? key_end<kRows>(row0, shift, s_kv) : s_kv) + kKeys - 1) / kKeys;
  };

  if (threadIdx.x >= 128) {
    // The producer warpgroup. Thread p = 0 lands each block's Q by TMA and
    // the warpgroup rounds it in place (lo beside it). K and V it reads
    // itself, a tile ahead into registers (thread p: K's chunks p + 128n,
    // V's column p), and stores each tile into its stage as the consumer
    // reads it: K's hi and lo in the slabs' swizzled layout, Vᵀ's hi and lo
    // key-permuted; then it arrives on the stage's `ready` barriers. Blocks
    // without a tile (causal, wholly in the future) are skipped by both
    // sides.
    const int p = threadIdx.x - 128;
    struct Tile {
      int n, bh, row0, it, n_tiles;  // tile `it` of the n-th block's n_tiles
    };
    auto seek = [&](int n, Tile& c) {  // the first tile of the first block from the n-th on that has one
      for (int bh, r; walk.next(n, bh, r); ++n) {
        const int row0 = block_row0(r), nt = tiles_of(row0);
        if (nt > 0) {
          c = Tile{n, bh, row0, 0, nt};
          return true;
        }
      }
      return false;
    };
    // K's chunks p + 128n (key p / 32 + 4n, columns 4·(p % 32) …) and V's column p of a tile
    auto load = [&](const Tile& c, float4 (&kr)[kChunks], float (&vr)[kKeys]) {
      if constexpr (Cut != kNoSplit) {
        const size_t row = (size_t)c.bh * s_kv + c.it * kKeys;
        const float4* kg = reinterpret_cast<const float4*>(k + row * kD) + p;
#pragma unroll
        for (int n = 0; n < kChunks; ++n) kr[n] = __ldg(kg + 128 * n);
        const float* vg = v + row * kD + p;
#pragma unroll
        for (int key = 0; key < kKeys; ++key) vr[key] = __ldg(vg + key * kD);
      }
    };
    Tile cur;
    if (!seek(0, cur)) return;
    float4 k_a[kChunks], k_b[kChunks];
    float v_a[kKeys], v_b[kKeys];
    load(cur, k_a, v_a);
    const float sgn = scale < 0.f ? -1.f : 1.f;  // folded into Q, so that the consumer scales by |scale|
    int gt = 0, nq = 0;
    // tile `cur` from registers kc, vc into its stage, the next one's loads into kn, vn meanwhile; false after the last
    auto step = [&](float4 (&kc)[kChunks], float (&vc)[kKeys], float4 (&kn)[kChunks], float (&vn)[kKeys]) {
      if (cur.it == 0) {  // a block's first tile: its Q first
        if (p == 0) {
          if (nq > 0) bar_wait(&sm.q_empty, (nq - 1) & 1);
          bar_expect(&sm.q_land, kRows * kD * 4);
#pragma unroll
          for (int h = 0; h < kSlabs; ++h)
            tma_box(sm.q + h * kRows * kSlab, map_q, h * kSlab, cur.bh * s_q + cur.row0, &sm.q_land);
          Tile after;
          if (seek(cur.n + 1, after))  // the next block's Q into L2 meanwhile
#pragma unroll
            for (int h = 0; h < kSlabs; ++h) tma_prefetch(map_q, h * kSlab, after.bh * s_q + after.row0);
        }
        bar_wait(&sm.q_land, nq & 1);
#pragma unroll 4
        for (int i = p; i < kRows * kD / 4; i += 128) {
          float4 x = reinterpret_cast<float4*>(sm.q)[i], hi, lo;
          split4(make_float4(sgn * x.x, sgn * x.y, sgn * x.z, sgn * x.w), hi, lo);
          reinterpret_cast<float4*>(sm.q)[i] = hi;
          if constexpr (Split) reinterpret_cast<float4*>(sm.q_lo)[i] = lo;
        }
        proxy_fence();
        bar_arrive(&sm.q_ready);
        ++nq;
      }
      Tile nxt = cur;
      const bool more = ++nxt.it < nxt.n_tiles || seek(cur.n + 1, nxt);
      if (more) load(nxt, kn, vn);  // in flight while this tile is stored
      const int st = gt % Ring;
      Stage& stage = sm.st[st];
      if (gt >= Ring) bar_wait(&sm.k_empty[st], (gt / Ring - 1) & 1);
      if constexpr (Cut != kNoSplit) {
#pragma unroll
        for (int n = 0; n < kChunks; ++n) {  // chunk c4 of key row `key` into slab c4 / 8, 16-byte chunk (c4 % 8) ^ (key % 8)
          const unsigned key = p / 32 + 4 * n, c4 = p % 32;
          const unsigned at = c4 / 8 * kKeys * kSlab + key * kSlab + (((c4 % 8) ^ (key & 7)) << 2);
          float4 hi, lo;
          split4(kc[n], hi, lo);
          *reinterpret_cast<float4*>(&stage.k[at]) = hi;
          if constexpr (Split) *reinterpret_cast<float4*>(&stage.k_lo[at]) = lo;
        }
      }
      proxy_fence();
      bar_arrive(&sm.k_ready[st]);
      if (gt >= Ring) bar_wait(&sm.v_empty[st], (gt / Ring - 1) & 1);
      if constexpr (Cut != kNoSplit) {
#pragma unroll
        for (int n = 0; n < kKeys / 4; ++n) {  // Vᵀ's positions 4n … 4n + 3 of row p: keys key0 + 0, 2, 4, 6
          const int key0 = (n >> 1) * 8 + (n & 1);
          float4 hi, lo;
          split4(make_float4(vc[key0], vc[key0 + 2], vc[key0 + 4], vc[key0 + 6]), hi, lo);
          const unsigned at = cidx<kVt>(p, 4 * n);
          *reinterpret_cast<float4*>(&stage.vt_hi[at]) = hi;
          if constexpr (Split) *reinterpret_cast<float4*>(&stage.vt_lo[at]) = lo;
        }
      }
      proxy_fence();
      bar_arrive(&sm.v_ready[st]);
      ++gt;
      cur = nxt;
      return more;
    };
    while (step(k_a, v_a, k_b, v_b) && step(k_b, v_b, k_a, v_a)) {
    }
    return;
  }

  // The consumer warpgroup: rows row0 … row0 + 63 of each block.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float c = fabsf(scale) * kLog2e;  // p = 2^(s·c − m): m is in units of log2
  const uint64_t q_desc = desc_sw128(smem_u32(sm.q));
  constexpr uint32_t kQLo = offsetof(S, q_lo) - offsetof(S, q);
  constexpr uint32_t kKLo = offsetof(Stage, k_lo), kVtLo = offsetof(Stage, vt_lo) - offsetof(Stage, vt_hi);
  auto release = [&](uint64_t* bar) {
    if (lane == 0) bar_arrive(bar);
  };
  int gt = 0, nq = 0;
  for (int n = 0, bh, r; walk.next(n, bh, r); ++n) {
    const int row0 = block_row0(r), n_tiles = tiles_of(row0);
    const int row_a = row0 + 16 * warp + g, row_b = row_a + 8;  // the two rows this thread holds
    // the tiles no row of the block masks (causal: those wholly below its diagonal)
    const int n_open = Causal ? min(n_tiles, max(row0 + shift + 1, 0) / kKeys) : n_tiles;

    float acc[(kD + 8) / 2];  // O and, in column D, the row sum l
#pragma unroll
    for (int i = 0; i < (kD + 8) / 2; ++i) acc[i] = 0.f;
    float m_a = -1e30f, m_b = -1e30f;  // finite: m − m_new is never inf − inf
    if (n_tiles > 0) {
      bar_wait(&sm.q_ready, nq & 1);
      // the tile's K (Vᵀ) stored by the producer
      auto k_ready = [&](int it) { bar_wait(&sm.k_ready[(gt + it) % Ring], ((gt + it) / Ring) & 1); };
      auto v_ready = [&](int it) { bar_wait(&sm.v_ready[(gt + it) % Ring], ((gt + it) / Ring) & 1); };
      if constexpr (Cut == kLoadsOnly) {
        release(&sm.q_empty);
        for (int it = 0; it < n_tiles; ++it) {
          k_ready(it);
          release(&sm.k_empty[(gt + it) % Ring]);
          v_ready(it);
          release(&sm.v_empty[(gt + it) % Ring]);
        }
      } else {
        float s[kKeys / 2], pv[(kD + 8) / 2];
        uint32_t p_hi[kKeys / 2], p_lo[kKeys / 2];
        float corr_a = 1.f, corr_b = 1.f, cn_a, cn_b;  // the correction of the tile whose P·V is in flight; the next
        auto scores = [&](int it) {  // S of tile `it`, issued into the open wgmma group
          if constexpr (Cut == kNoMma) {
#pragma unroll
            for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.03125f * i;
          } else {
            // the Q descriptor re-read a tile, so that the compiler forms its 32
            // step descriptors at the products and does not hold them all in registers
            uint64_t q = q_desc;
            asm volatile("" : "+l"(q));
            issue_scores<Split>(s, q, desc_sw128(smem_u32(sm.st[(gt + it) % Ring].k)), kQLo, kKLo);
          }
        };
        auto products = [&](int it) {  // P·[V | 1 | 0] of tile `it`, issued into the open wgmma group
          if constexpr (Cut == kNoMma) {
#pragma unroll
            for (int i = 0; i < (kD + 8) / 2; ++i) pv[i] = 0.f;
          } else {
            issue_pv<Split>(pv, p_hi, p_lo, smem_u32(sm.st[(gt + it) % Ring].vt_hi) >> 4, kVtLo);
          }
        };
        auto softmax = [&](int it) {  // only the tiles across the diagonal are masked
          if (Causal && it >= n_open)
            softmax_tile<kKeys, true, Cut>(s, it * kKeys, row_a, row_b, shift, t, c, m_a, m_b, cn_a, cn_b);
          else
            softmax_tile<kKeys, false, Cut>(s, it * kKeys, row_a, row_b, shift, t, c, m_a, m_b, cn_a, cn_b);
        };
        // O = O·corr + P·V (and l = l·corr + Σ P) in FFMAs: the tensor
        // cores' sums span one tile (flash_fwd_tc's order)
        auto merge = [&]() {
#pragma unroll
          for (int j = 0; j < (kD + 8) / 8; ++j) {
            acc[4 * j] = fmaf(acc[4 * j], corr_a, pv[4 * j]);
            acc[4 * j + 1] = fmaf(acc[4 * j + 1], corr_a, pv[4 * j + 1]);
            acc[4 * j + 2] = fmaf(acc[4 * j + 2], corr_b, pv[4 * j + 2]);
            acc[4 * j + 3] = fmaf(acc[4 * j + 3], corr_b, pv[4 * j + 3]);
          }
        };
        auto next_p = [&]() {  // the softmaxed tile's P as the next A operand, and its correction
          split_frag<kKeys / 2, Split>(s, p_hi, p_lo);
          corr_a = cn_a;
          corr_b = cn_b;
        };
        auto pin_pv = [&]() {  // P·V's registers stay untouched until its products are done
          pin(pv);
          pin(p_hi);
          if constexpr (Split) pin(p_lo);
        };
        // tile 0's scores; then each tile's scores issued with the last
        // tile's P·V, which runs under this tile's softmax; the last P·V
        k_ready(0);
        wg_fence();
        scores(0);
        wg_commit();
        wg_wait();
        pin(s);
        release(&sm.k_empty[gt % Ring]);
        if (n_tiles == 1) release(&sm.q_empty);
        softmax(0);
        next_p();
        for (int it = 1; it < n_tiles; ++it) {
          k_ready(it);
          v_ready(it - 1);
          wg_fence();
          scores(it);
          wg_commit();
          products(it - 1);
          wg_commit();
          wait_group<1>();  // the scores; P·V may still run
          pin(s);
          release(&sm.k_empty[(gt + it) % Ring]);
          if (it == n_tiles - 1) release(&sm.q_empty);
          softmax(it);
          wait_group<0>();
          pin_pv();
          release(&sm.v_empty[(gt + it - 1) % Ring]);
          merge();
          next_p();
        }
        v_ready(n_tiles - 1);
        wg_fence();
        products(n_tiles - 1);
        wg_commit();
        wg_wait();
        pin_pv();
        release(&sm.v_empty[(gt + n_tiles - 1) % Ring]);
        merge();
      }
      gt += n_tiles;
      ++nq;
    }

    // l: column D, held by the quad's thread t = 0
    const float l_a = __shfl_sync(0xffffffffu, acc[kD / 2], lane & ~3);
    const float l_b = __shfl_sync(0xffffffffu, acc[kD / 2 + 2], lane & ~3);
    // masked-row guard: a row that saw no key has l == 0 and acc == 0
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f, inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    float* oa = o + ((size_t)bh * s_q + row_a) * kD + 2 * t;
    float* ob = o + ((size_t)bh * s_q + row_b) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      *reinterpret_cast<float2*>(oa + 8 * j) = make_float2(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      *reinterpret_cast<float2*>(ob + 8 * j) = make_float2(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    }
    if (t == 0) {
      lse[(size_t)bh * s_q + row_a] = l_a > 0.f ? fmaf(m_a, kLn2, logf(l_a)) : -1e30f;
      lse[(size_t)bh * s_q + row_b] = l_b > 0.f ? fmaf(m_b, kLn2, logf(l_b)) : -1e30f;
    }
  }
}

// One launch of the head-dim-128 forward with Ring operand stages; the cudaError_t of the launch.
template <bool Causal, bool Split, int Ring = 2, int Cut = kFull>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q, int s_kv, int shift,
           float scale, cudaStream_t st) {
  CUtensorMap mq;
  int e = hopper_tma::tensor_map_f32_2d(&mq, q, (long long)bh * s_q, kD, kSlab, kRows);
  int grid = 0;
  if (e == 0) e = hopper_tma::persistent_grid(bh * (s_q / kRows), &grid);
  if (e != 0) return e;
  return hopper_tma::launch(flash_fwd_d128_tc<Causal, Split, Ring, Cut>, (int)sizeof(Smem<Ring>) + 1024, dim3(grid),
                            kThreads, st, mq, k, v, o, lse, bh, s_q, s_kv, shift, scale);
}

}  // namespace fwd128

// One launch of flash_fwd_tc; the cudaError_t of the launch.
template <int D, bool Causal, bool Split, int Cut = kFull>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q, int s_kv,
               int shift, float scale, cudaStream_t st) {
  constexpr int kSmem = sizeof(Smem<D>);
  const cudaError_t e = cudaFuncSetAttribute(flash_fwd_tc<D, Causal, Split, Cut>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_tc<D, Causal, Split, Cut><<<dim3(s_q / Plan<D>::kRows, bh), Plan<D>::kThreads, kSmem, st>>>(
      q, k, v, o, lse, s_q, s_kv, shift, scale);
  return (int)cudaGetLastError();
}

#ifdef FLASH_F32_CUTS
// A launch of flash_fwd_tc's attribution cut `Cut` at an instance the entry
// points run: split at D = 16, 32 and 64, one pass at D = 32 and 64 (one
// pass at D = 16 runs onepass::flash_fwd_1p_tc); else cudaErrorInvalidValue.
template <int D, bool Causal, int Cut>
int launch_fwd_cut(bool split, const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q,
                   int s_kv, int shift, float scale, cudaStream_t st) {
  if (split) return launch_fwd<D, Causal, true, Cut>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
  if constexpr (D == 16)
    return (int)cudaErrorInvalidValue;
  else
    return launch_fwd<D, Causal, false, Cut>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
}
#endif

// The instance of a launch template for (d, causal, split): `KERNEL_CASES_64(fn,
// args)` expands to the switch cases over D in {16, 32, 64}; D = 128 (cases
// 12 … 15) runs the kernels of its own.
#define KERNEL_CASES_64(fn, ...)                                                           \
  case 0: return fn<16, false, false>(__VA_ARGS__);                                        \
  case 1: return fn<16, false, true>(__VA_ARGS__);                                         \
  case 2: return fn<16, true, false>(__VA_ARGS__);                                         \
  case 3: return fn<16, true, true>(__VA_ARGS__);                                          \
  case 4: return fn<32, false, false>(__VA_ARGS__);                                        \
  case 5: return fn<32, false, true>(__VA_ARGS__);                                         \
  case 6: return fn<32, true, false>(__VA_ARGS__);                                         \
  case 7: return fn<32, true, true>(__VA_ARGS__);                                          \
  case 8: return fn<64, false, false>(__VA_ARGS__);                                        \
  case 9: return fn<64, false, true>(__VA_ARGS__);                                         \
  case 10: return fn<64, true, false>(__VA_ARGS__);                                        \
  case 11: return fn<64, true, true>(__VA_ARGS__);

// the case of (d, causal, split), or -1 for a head dim without an instance
int instance(int d, bool causal, bool split) {
  const int di = d == 16 ? 0 : d == 32 ? 1 : d == 64 ? 2 : d == 128 ? 3 : -1;
  return di < 0 ? -1 : 4 * di + 2 * (causal ? 1 : 0) + (split ? 1 : 0);
}


// ---------------------------------------------------------------------------
// The backward on the tensor cores, both families (see the note at the top).
// ---------------------------------------------------------------------------

// acc (+)= A·Bᵀ over D columns in split TF32, small products first (one
// pass, hi·hi, without Split): A is this warpgroup's 64-row operand
// (descriptor base a16, hi/lo at byte offsets a_hi, a_lo), B an N-row operand
// (base b16, offsets b_hi, b_lo), both in shared memory. The first product
// overwrites acc.
template <int D, int N, bool Split>
__device__ __forceinline__ void ss_split(float (&acc)[N / 2], uint32_t a16, uint32_t a_hi, uint32_t a_lo,
                                         uint32_t b16, uint32_t b_hi, uint32_t b_lo) {
  if constexpr (Split) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {  // bytes to columns 8ks … 8ks + 7: 32·R·ks for R rows
      wgmma_ss<N>(acc, desc<64>(a16, a_lo + 2048 * ks), desc<N>(b16, b_hi + 32 * N * ks), ks > 0);
      wgmma_ss<N>(acc, desc<64>(a16, a_hi + 2048 * ks), desc<N>(b16, b_lo + 32 * N * ks), 1);
    }
  }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
    wgmma_ss<N>(acc, desc<64>(a16, a_hi + 2048 * ks), desc<N>(b16, b_hi + 32 * N * ks), Split || ks > 0);
}

// acc (+)= X·B over T contraction positions in split TF32, small products
// first (one pass, hi·hi, without Split); with accumulate = 0 the first
// product overwrites acc. X is the
// [64 x T] accumulator of an earlier product, split into xh/xl:
// a thread holds its columns 8j + 2t + e, which the TF32 A fragment takes at
// positions {t, t + 4}; B (N rows by T positions, base b16, hi/lo at b_hi,
// b_lo) stores each 8 of its positions in the order 0, 2, 4, 6, 1, 3, 5, 7 to
// match, so the registers are the fragment as they stand. B's N rows may be
// rows of an operand of L rows (b_hi, b_lo then point at the first).
template <int N, int T, bool Split, int L = N>
__device__ __forceinline__ void rs_split(float (&acc)[N / 2], const uint32_t (&xh)[T / 2],
                                         const uint32_t (&xl)[T / 2], uint32_t b16, uint32_t b_hi, uint32_t b_lo,
                                         int accumulate = 1) {
  if constexpr (Split) {
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      const uint32_t a_lo[4] = {xl[4 * j], xl[4 * j + 2], xl[4 * j + 1], xl[4 * j + 3]};
      const uint32_t a_hi[4] = {xh[4 * j], xh[4 * j + 2], xh[4 * j + 1], xh[4 * j + 3]};
      wgmma_rs<N>(acc, a_lo, desc<L>(b16, b_hi + 32 * L * j), j > 0 || accumulate);
      wgmma_rs<N>(acc, a_hi, desc<L>(b16, b_lo + 32 * L * j), 1);
    }
  }
#pragma unroll
  for (int j = 0; j < T / 8; ++j) {
    const uint32_t a_hi[4] = {xh[4 * j], xh[4 * j + 2], xh[4 * j + 1], xh[4 * j + 3]};
    wgmma_rs<N>(acc, a_hi, desc<L>(b16, b_hi + 32 * L * j), Split || j > 0 || accumulate);
  }
}

// rows [row0, row0 + kRows) of a [S, D] matrix (src at row0) split into hi/lo
// in the operand layout of 64-row operands, one a warpgroup
template <int D, bool Split>
__device__ __forceinline__ void split_rows(float* hi, float* lo, const float* src) {
  constexpr int kRows = Plan<D>::kRows, kThreads = Plan<D>::kThreads;
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int n = 0; n < kRows * D / 4 / kThreads; ++n) {
    const unsigned i = threadIdx.x + n * kThreads, r = i / (D / 4);
    float4 h, l;
    split4(__ldg(s4 + i), h, l);
    const unsigned at = r / 64 * 64 * D + cidx<64>(r % 64, i % (D / 4) * 4);
    *reinterpret_cast<float4*>(&hi[at]) = h;
    if constexpr (Split) *reinterpret_cast<float4*>(&lo[at]) = l;
  }
}

// cp.async of T rows of a [S, D] matrix (src at the first) into dst: row-major,
// or in the operand layout of a T-row operand
template <int D, int T, bool Operand>
__device__ __forceinline__ void load_rows(float* dst, const float* src) {
#pragma unroll
  for (unsigned i = threadIdx.x; i < T * D / 4; i += Plan<D>::kThreads)  // chunk i: row i / (D/4), columns 4·(i % (D/4)) + 0..3
    cp_async16(dst + (Operand ? cidx<T>(i / (D / 4), i % (D / 4) * 4) : 4 * i), src + 4 * i);
}

// A landed tile in operand layout into its hi/lo at the same index.
template <int D, int T, bool Split>
__device__ __forceinline__ void split_same(const float* raw, float* hi, float* lo) {
#pragma unroll
  for (unsigned i = threadIdx.x; i < T * D / 4; i += Plan<D>::kThreads) {
    float4 h, l;
    split4(reinterpret_cast<const float4*>(raw)[i], h, l);
    reinterpret_cast<float4*>(hi)[i] = h;
    if constexpr (Split) reinterpret_cast<float4*>(lo)[i] = l;
  }
}

// A landed row-major [T x D] tile into the hi/lo of two operands: itself (T
// rows by D, contraction over D) and its transpose (D rows by T positions,
// the rows of every 8 stored in the order 0, 2, 4, 6, 1, 3, 5, 7, as
// `rs_split` reads them).
template <int D, int T, bool Split>
__device__ __forceinline__ void split_both(const float* raw, float* hi, float* lo, float* t_hi, float* t_lo) {
#pragma unroll
  for (unsigned i = threadIdx.x; i < T * D / 4; i += Plan<D>::kThreads) {
    float4 h, l;
    split4(reinterpret_cast<const float4*>(raw)[i], h, l);
    const unsigned at = cidx<T>(i / (D / 4), i % (D / 4) * 4);
    *reinterpret_cast<float4*>(&hi[at]) = h;
    if constexpr (Split) *reinterpret_cast<float4*>(&lo[at]) = l;
  }
#pragma unroll
  for (unsigned i = threadIdx.x; i < T * D / 4; i += Plan<D>::kThreads) {
    const unsigned d = i % D, pg = i / D;          // positions 4pg … 4pg + 3 of the transpose's row d
    const unsigned r0 = (pg >> 1) * 8 + (pg & 1);  // hold rows r0 + 0, 2, 4, 6
    float4 x = make_float4(raw[r0 * D + d], raw[(r0 + 2) * D + d], raw[(r0 + 4) * D + d], raw[(r0 + 6) * D + d]);
    float4 h, l;
    split4(x, h, l);
    const unsigned at = cidx<D>(d, 4 * pg);
    *reinterpret_cast<float4*>(&t_hi[at]) = h;
    if constexpr (Split) *reinterpret_cast<float4*>(&t_lo[at]) = l;
  }
}

// lse in units of log2, +inf for a row that saw no key (lse = −1e30): then
// P = 2^(s·c − lse2) is exactly 0 without a select
__device__ __forceinline__ float lse2(float lse) { return lse > -0.5e30f ? lse * kLog2e : INFINITY; }

template <int D>
struct SmemDq {
  static constexpr int R = Plan<D>::kRows, T = Plan<D>::kDqTile;
  float q_hi[R * D], q_lo[R * D];            // per warpgroup a 64-row operand
  float do_hi[R * D], do_lo[R * D];          // the same for dO
  float raw[kStages][2][T * D];              // landed tiles: K (row-major) and V (operand layout)
  float k_hi[T * D], k_lo[T * D];            // operand layout, T rows (keys) by D
  float v_hi[T * D], v_lo[T * D];
  float kt_hi[D * T], kt_lo[D * T];          // Kᵀ: D rows by T permuted keys
};

template <int D>
struct SmemDkv {
  static constexpr int R = Plan<D>::kRows, T = Plan<D>::kDkvTile;
  float k_hi[R * D], k_lo[R * D];            // per warpgroup a 64-row operand
  float v_hi[R * D], v_lo[R * D];
  float raw[kStages][2][T * D];              // landed tiles: Q and dO, row-major
  float raw_stats[kStages][2][T];            // and the tile's lse and delta
  float q_hi[T * D], q_lo[T * D];            // operand layout, T rows (queries) by D
  float do_hi[T * D], do_lo[T * D];
  float qt_hi[D * T], qt_lo[D * T];          // Qᵀ and dOᵀ: D rows by T permuted queries
  float dot_hi[D * T], dot_lo[D * T];
  float lse2[T], delta[T];
};
static_assert(sizeof(SmemDq<64>) <= 232448 && sizeof(SmemDkv<64>) <= 232448, "over 227 KB of shared memory");

// dq of q, dO [BH, Sq, D] against k, v [BH, Skv, D] for D up to 64: dq =
// scale · Σ_j dS_ij k_j, in split TF32 or (without Split) one pass.
// Grid (Sq / kRows, BH), kThreads threads (`Plan<D>`), sizeof(SmemDq<D>)
// bytes of dynamic shared memory; two blocks an SM at D = 16 (at most 128
// registers). D = 128 runs dq128::flash_bwd_dq_d128_tc (below), the same
// arithmetic.
template <int D, bool Causal, bool Split>
__global__ void __launch_bounds__(Plan<D>::kThreads, D == 16 ? 2 : 1)
flash_bwd_dq_tc(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int s_q, int s_kv, int shift, float scale) {
  static_assert(D <= 64, "D = 128 runs dq128::flash_bwd_dq_d128_tc");
  constexpr int T = Plan<D>::kDqTile, kRows = Plan<D>::kRows;
  using S = SmemDq<D>;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int bh = blockIdx.y;
  const int row0 = (Causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;  // causal: heaviest first
  const float* kb = k + (size_t)bh * s_kv * D;
  const float* vb = v + (size_t)bh * s_kv * D;
  const int kend = Causal ? key_end<kRows>(row0, shift, s_kv) : s_kv;
  const int n_tiles = (kend + T - 1) / T;  // tiles past s_kv are never read: s_kv % kBlock == 0

#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_tiles) {
      load_rows<D, T, false>(sm.raw[st][0], kb + (size_t)st * T * D);
      load_rows<D, T, true>(sm.raw[st][1], vb + (size_t)st * T * D);
    }
    cp_async_commit();
  }
  const size_t qrow = (size_t)bh * s_q + row0;
  split_rows<D, Split>(sm.q_hi, sm.q_lo, q + qrow * D);
  split_rows<D, Split>(sm.do_hi, sm.do_lo, dout + qrow * D);
  proxy_fence();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = row0 + 64 * wg;                            // this warpgroup's first query row
  const int row_a = wrow0 + 16 * warp + g, row_b = row_a + 8;  // the two rows this thread holds
  const uint32_t base16 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bytes)) >> 4;
  const uint32_t a16 = base16 + 64 * D * 4 / 16 * wg;  // this warpgroup's rows of Q and dO
  const float c = scale * kLog2e;                       // P = 2^(s·c − lse2)
  const float lse_a = lse2(__ldg(lse + (size_t)bh * s_q + row_a)), lse_b = lse2(__ldg(lse + (size_t)bh * s_q + row_b));
  const float dl_a = __ldg(delta + (size_t)bh * s_q + row_a), dl_b = __ldg(delta + (size_t)bh * s_q + row_b);

  float acc[D / 2];  // dq / scale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 1>();  // this thread's copies of tile `it` have landed
    __syncthreads();               // everyone's; and the last tile's wgmmas are done
    split_both<D, T, Split>(sm.raw[st][0], sm.k_hi, sm.k_lo, sm.kt_hi, sm.kt_lo);
    split_same<D, T, Split>(sm.raw[st][1], sm.v_hi, sm.v_lo);
    proxy_fence();
    __syncthreads();
    if (it + kStages < n_tiles) {
      load_rows<D, T, false>(sm.raw[st][0], kb + (size_t)(it + kStages) * T * D);
      load_rows<D, T, true>(sm.raw[st][1], vb + (size_t)(it + kStages) * T * D);
    }
    cp_async_commit();

    const int kt = it * T;
    if (Causal && kt > wrow0 + 63 + shift) continue;  // wholly in this warpgroup's future

    // S = Q·Kᵀ and dP = dO·Vᵀ. s[4j + e] is (row_a, key kt + 8j + 2t + e),
    // s[4j + 2 + e] the same key on row_b; dp likewise.
    float s[T / 2], dp[T / 2];
    wg_fence();
    ss_split<D, T, Split>(s, a16, offsetof(S, q_hi), offsetof(S, q_lo), base16, offsetof(S, k_hi), offsetof(S, k_lo));
    ss_split<D, T, Split>(dp, a16, offsetof(S, do_hi), offsetof(S, do_lo), base16, offsetof(S, v_hi),
                          offsetof(S, v_lo));
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // dS = P ∘ (dP − delta) into s; masked pairs and dead rows have P = 0 exactly
    const bool mask = Causal && kt + T - 1 > wrow0 + shift;  // the tile crosses the diagonal
#pragma unroll
    for (int j = 0; j < T / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float pa = exp2_ftz(fmaf(s[4 * j + e], c, -lse_a));
        float pb = exp2_ftz(fmaf(s[4 * j + 2 + e], c, -lse_b));
        if (mask) {
          const int key = kt + 8 * j + 2 * t + e;
          pa = key > row_a + shift ? 0.f : pa;
          pb = key > row_b + shift ? 0.f : pb;
        }
        s[4 * j + e] = pa * (dp[4 * j + e] - dl_a);
        s[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dl_b);
      }

    // dq += dS·K with dS in registers, against Kᵀ; causal: the tile's
    // product sums apart and joins acc in f32 adds
    uint32_t xh[T / 2], xl[T / 2];
    split_frag<T / 2, Split>(s, xh, xl);
    wg_fence();
    if constexpr (Causal) {
      float part[D / 2];
      rs_split<D, T, Split>(part, xh, xl, base16, offsetof(S, kt_hi), offsetof(S, kt_lo), 0);
      wg_commit();
      wg_wait();
      pin(part);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
    } else {
      rs_split<D, T, Split>(acc, xh, xl, base16, offsetof(S, kt_hi), offsetof(S, kt_lo));
      wg_commit();
      wg_wait();
      pin(acc);
    }
  }

  float* da = dq + ((size_t)bh * s_q + row_a) * D + 2 * t;
  float* db = dq + ((size_t)bh * s_q + row_b) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(da + 8 * j) = make_float2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    *reinterpret_cast<float2*>(db + 8 * j) = make_float2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// dk, dv of k, v [BH, Skv, D] from the same inputs for D up to 64: dv =
// Σ_i P_ijᵀ dO_i, dk = scale · Σ_i dS_ijᵀ q_i, in split TF32. Grid (Skv /
// kRows, BH), kThreads threads (`Plan<D>`), sizeof(SmemDkv<D>) bytes of
// dynamic shared memory; two blocks an SM at D = 16 (at most 128
// registers). D = 128 runs bwd128::flash_bwd_dkv_d128_tc (below), the same
// arithmetic; one pass, onepass::flash_bwd_dkv_1p_tc.
template <int D, bool Causal>
__global__ void __launch_bounds__(Plan<D>::kThreads, D == 16 ? 2 : 1)
flash_bwd_dkv_tc(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int s_q, int s_kv, int shift, float scale) {
  static_assert(D <= 64, "D = 128 runs bwd128::flash_bwd_dkv_d128_tc");
  constexpr int T = Plan<D>::kDkvTile, kRows = Plan<D>::kRows;
  using S = SmemDkv<D>;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kRows;  // causal: the first blocks see the most queries
  const float* qb = q + (size_t)bh * s_q * D;
  const float* dob = dout + (size_t)bh * s_q * D;
  const float* lseb = lse + (size_t)bh * s_q;
  const float* deltab = delta + (size_t)bh * s_q;
  // causal: query rows before key0 − shift see none of this block's keys
  const int qt0 = Causal ? min(max(key0 - shift, 0), s_q) / T * T : 0;
  const int n_tiles = (s_q - qt0) / T;

  auto load = [&](int st, int qt) {
    load_rows<D, T, false>(sm.raw[st][0], qb + (size_t)qt * D);
    load_rows<D, T, false>(sm.raw[st][1], dob + (size_t)qt * D);
    if (threadIdx.x < T) {
      cp_async4(&sm.raw_stats[st][0][threadIdx.x], lseb + qt + threadIdx.x);
      cp_async4(&sm.raw_stats[st][1][threadIdx.x], deltab + qt + threadIdx.x);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < n_tiles) load(st, qt0 + st * T);
    cp_async_commit();
  }
  const size_t krow = (size_t)bh * s_kv + key0;
  split_rows<D, true>(sm.k_hi, sm.k_lo, k + krow * D);
  split_rows<D, true>(sm.v_hi, sm.v_lo, v + krow * D);
  proxy_fence();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wkey0 = key0 + 64 * wg;                            // this warpgroup's first key row
  const int key_a = wkey0 + 16 * warp + g, key_b = key_a + 8;  // the two key rows this thread holds
  const uint32_t base16 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_bytes)) >> 4;
  const uint32_t a16 = base16 + 64 * D * 4 / 16 * wg;  // this warpgroup's rows of K and V
  const float c = scale * kLog2e;                       // P = 2^(s·c − lse2)

  float dka[D / 2], dva[D / 2];  // dk / scale and dv
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 1>();
    __syncthreads();
    split_both<D, T, true>(sm.raw[st][0], sm.q_hi, sm.q_lo, sm.qt_hi, sm.qt_lo);
    split_both<D, T, true>(sm.raw[st][1], sm.do_hi, sm.do_lo, sm.dot_hi, sm.dot_lo);
    if (threadIdx.x < T) {
      sm.lse2[threadIdx.x] = lse2(sm.raw_stats[st][0][threadIdx.x]);
      sm.delta[threadIdx.x] = sm.raw_stats[st][1][threadIdx.x];
    }
    proxy_fence();
    __syncthreads();
    if (it + kStages < n_tiles) load(st, qt0 + (it + kStages) * T);
    cp_async_commit();

    const int qt = qt0 + it * T;
    if (Causal && qt + T - 1 < wkey0 - shift) continue;  // every query of the tile precedes this warpgroup's keys

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ. s[4j + e] is (key_a, query qt + 8j + 2t + e),
    // s[4j + 2 + e] the same query on key_b; dp likewise. The query's lse and
    // delta are per column.
    float s[T / 2], dp[T / 2];
    wg_fence();
    ss_split<D, T, true>(s, a16, offsetof(S, k_hi), offsetof(S, k_lo), base16, offsetof(S, q_hi), offsetof(S, q_lo));
    ss_split<D, T, true>(dp, a16, offsetof(S, v_hi), offsetof(S, v_lo), base16, offsetof(S, do_hi),
                          offsetof(S, do_lo));
    wg_commit();
    wg_wait();
    pin(s);
    pin(dp);

    // Pᵀ into s, dSᵀ = Pᵀ ∘ (dPᵀ − delta) into dp
    const bool mask = Causal && wkey0 + 63 > qt + shift;  // the tile crosses the diagonal
#pragma unroll
    for (int j = 0; j < T / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse2[8 * j + 2 * t]);
      const float2 dl = *reinterpret_cast<const float2*>(&sm.delta[8 * j + 2 * t]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = e ? l2.y : l2.x, d = e ? dl.y : dl.x;
        float pa = exp2_ftz(fmaf(s[4 * j + e], c, -l));
        float pb = exp2_ftz(fmaf(s[4 * j + 2 + e], c, -l));
        if (mask) {
          const int query = qt + 8 * j + 2 * t + e;
          pa = key_a > query + shift ? 0.f : pa;
          pb = key_b > query + shift ? 0.f : pb;
        }
        s[4 * j + e] = pa;
        s[4 * j + 2 + e] = pb;
        dp[4 * j + e] = pa * (dp[4 * j + e] - d);
        dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - d);
      }
    }

    // dv += Pᵀ·dO against dOᵀ and dk += dSᵀ·Q against Qᵀ, Pᵀ and dSᵀ in registers
    if constexpr (Causal) {
      // each product of the tile sums apart and joins dv, dk in f32 adds; one
      // after the other, so that one partial sum and one split operand are
      // live at a time beside the two accumulators
      float part[D / 2];
      uint32_t ph[T / 2], pl[T / 2];
      split_frag<T / 2, true>(s, ph, pl);
      wg_fence();
      rs_split<D, T, true>(part, ph, pl, base16, offsetof(S, dot_hi), offsetof(S, dot_lo), 0);
      wg_commit();
      wg_wait();
      pin(part);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dva[i] += part[i];
      uint32_t dh[T / 2], dl[T / 2];
      split_frag<T / 2, true>(dp, dh, dl);
      wg_fence();
      rs_split<D, T, true>(part, dh, dl, base16, offsetof(S, qt_hi), offsetof(S, qt_lo), 0);
      wg_commit();
      wg_wait();
      pin(part);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] += part[i];
    } else {
      uint32_t ph[T / 2], pl[T / 2], dh[T / 2], dl[T / 2];
      split_frag<T / 2, true>(s, ph, pl);
      split_frag<T / 2, true>(dp, dh, dl);
      wg_fence();
      rs_split<D, T, true>(dva, ph, pl, base16, offsetof(S, dot_hi), offsetof(S, dot_lo));
      rs_split<D, T, true>(dka, dh, dl, base16, offsetof(S, qt_hi), offsetof(S, qt_lo));
      wg_commit();
      wg_wait();
      pin(dva);
      pin(dka);
    }
  }

  float* ka = dk + ((size_t)bh * s_kv + key_a) * D + 2 * t;
  float* kb = dk + ((size_t)bh * s_kv + key_b) * D + 2 * t;
  float* va = dv + ((size_t)bh * s_kv + key_a) * D + 2 * t;
  float* vb = dv + ((size_t)bh * s_kv + key_b) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(ka + 8 * j) = make_float2(dka[4 * j] * scale, dka[4 * j + 1] * scale);
    *reinterpret_cast<float2*>(kb + 8 * j) = make_float2(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
    *reinterpret_cast<float2*>(va + 8 * j) = make_float2(dva[4 * j], dva[4 * j + 1]);
    *reinterpret_cast<float2*>(vb + 8 * j) = make_float2(dva[4 * j + 2], dva[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// dk/dv at head dim 128 (the note at the top: head dim 128)
// ---------------------------------------------------------------------------
namespace bwd128 {

using fwd128::wait_group;
using fwd128::Walk;
using hopper_tma::aligned_smem;
using hopper_tma::bar_arrive;
using hopper_tma::bar_expect;
using hopper_tma::bar_init;
using hopper_tma::bar_wait;
using hopper_tma::bulk_copy;
using hopper_tma::named_arrive;
using hopper_tma::named_sync;
using hopper_tma::regs_dec;
using hopper_tma::regs_inc;
using hopper_tma::smem_u32;
using hopper_tma::tma_box;
using hopper_tma::tma_prefetch;

constexpr int kD = 128;
constexpr int kRows = 64;           // key rows a block owns
constexpr int kTile = 16;           // queries a tile
constexpr int kThreads = 384;       // consumer warpgroups 0 (Sᵀ, dv) and 1 (dPᵀ, dk), then the producer warpgroup
constexpr int kSlab = 32;           // floats a swizzled row (128 bytes): the columns of a slab
constexpr int kSlabs = kD / kSlab;
constexpr int kRawStages = 3;       // tiles of Q and dO in flight from device memory
constexpr int kSmemLimit = 232448;  // shared memory a block may have
constexpr int kRegisters = 65536;   // registers of an SM
constexpr int kProducerRegs = 48, kConsumerRegs = 224;  // setmaxnreg
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= kRegisters, "setmaxnreg over the SM's registers");
// named barriers (0 is __syncthreads): a tile's P handed from consumer 0 to
// consumer 1 through slot s (kPFull + s: written; kPFree + s: read), each
// consumer's own (kOwn + warpgroup), the producer's
constexpr int kPFull = 1, kPFree = 3, kOwn = 5, kProducerBar = 7;

// A tile's operands of Sᵀ and dPᵀ: Q's and dO's hi and lo, each four slabs
// of 16 queries by 32 floats with the 128-byte swizzle (`desc_sw128`)
struct Scores {
  float q[kTile * kD], q_lo[kTile * kD];
  float dout[kTile * kD], do_lo[kTile * kD];
};
static_assert(sizeof(Scores) == 32768, "a stage keeps its slabs 1 KB aligned");

// A tile of Q and dO as the TMA lands them (the slabs of `Scores`' layout)
struct Raw {
  float q[kTile * kD], dout[kTile * kD];
};

// A tile's operands of dv and dk: Qᵀ's and dOᵀ's hi and lo, D rows by 16
// queries with the queries of every 8 in the order 0, 2, 4, 6, 1, 3, 5, 7
// (`cidx<kD>`), as `rs_split` reads them
struct Transposes {
  float qt_hi[kD * kTile], qt_lo[kD * kTile];
  float dot_hi[kD * kTile], dot_lo[kD * kTile];
};

template <int Ring>
struct Smem {
  alignas(1024) float k_lo[kRows * kD];  // K as the TMA landed it (four slabs of 64 rows by 32 floats), then K − hi
  alignas(1024) float v_lo[kRows * kD];  // V likewise
  alignas(1024) Scores st[Ring];         // the scores' operands: a ring of Ring stages
  alignas(1024) Raw raw[kRawStages];     // Q and dO as landed
  Transposes tr;                         // the products' operands: one stage
  float4 p[2][2][128];                   // a tile's P, consumer 0's thread i to consumer 1's: [slot][half][i]
  float raw_stats[kRawStages][2][kTile];  // each raw stage's lse and delta as landed
  float stats[Ring][2][kTile];            // each score stage's lse2 and delta
  uint64_t kv_land, kv_empty, raw_full[kRawStages];
  uint64_t s_ready[Ring], s_empty[Ring], t_ready, t_empty;
};
// The plans' bytes (the launch asks for 1 KB more, to align the slabs): two
// score stages (shipped), one (chip_sweep.py flash_f32). A second stage of
// the transposes does not fit beside two score stages.
static_assert(sizeof(Smem<2>) == 222208 && sizeof(Smem<2>) + 1024 <= kSmemLimit, "two stages over 227 KB");
static_assert(sizeof(Smem<1>) == 189440 && sizeof(Smem<1>) + 1024 <= kSmemLimit, "one stage over 227 KB");
static_assert(sizeof(Smem<2>) + sizeof(Transposes) + 1024 > kSmemLimit, "a second transposes stage would fit");

// component i of x
__device__ __forceinline__ float at4(const float4& x, int i) { return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w; }

// float index of element (r, d) of a tile of R rows stored as four slabs of R
// rows by 32 floats with the 128-byte swizzle (the layout of a TMA box of 32
// columns): slab d / 32, row r, 16-byte chunk (d % 32 / 4) ^ (r % 8)
template <int R>
__device__ __forceinline__ unsigned swz(unsigned r, unsigned d) {
  return d / kSlab * R * kSlab + r * kSlab + ((((d % kSlab) >> 2) ^ (r & 7)) << 2) + (d & 3);
}

// the A fragment of k8 step ks among a warpgroup's 64 operand registers
__device__ __forceinline__ const uint32_t (&frag(const uint32_t (&a)[64], int ks))[4] {
  return *reinterpret_cast<const uint32_t(*)[4]>(&a[4 * ks]);
}

// A 64-row operand as the TMA landed it (`rows`: four slabs of 64 rows by 32
// floats, swizzled) into its hi as a warpgroup's A fragments (step ks: rows
// 16·warp + g (+ 8), columns 8ks + t (+ 4)) and, with Split, its lo in
// place; each element is read and rewritten by the thread that holds it
template <bool Split>
__device__ __forceinline__ void take_hi(float* rows, uint32_t (&ah)[64], int warp, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned at = swz<kRows>(16 * warp + g + 8 * (e & 1), 8 * ks + t + 4 * (e >> 1));
      const float x = rows[at];
      ah[4 * ks + e] = tf32(x);
      if constexpr (Split) rows[at] = x - __uint_as_float(ah[4 * ks + e]);
    }
  pin(ah);
}

// Sᵀ (dPᵀ) = A·Bᵀ over D into s, flash_bwd_dkv_tc's products in its order
// (small ones first; one pass: hi·hi): A is the block's K (V), its hi in
// registers (`ah`) and its lo in shared memory (descriptor a_lo of its first
// slab), B the tile's Q (dO), descriptor b of its hi's first slab, lo b_lo
// bytes past it; k8 step ks lies in slab ks / 4, 32·(ks % 4) bytes into the
// rows.
template <bool Split>
__device__ __forceinline__ void issue_st(float (&s)[kTile / 2], const uint32_t (&ah)[64], uint64_t a_lo, uint64_t b,
                                         uint32_t b_lo) {
  constexpr uint32_t kSlabA = kRows * 128, kSlabB = kTile * 128;  // bytes of a slab
  if constexpr (Split) {
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks) {
      const uint32_t ao = (ks / 4 * kSlabA + 32 * (ks % 4)) >> 4, bo = (ks / 4 * kSlabB + 32 * (ks % 4)) >> 4;
      wgmma_ss<kTile>(s, a_lo + ao, b + bo, ks > 0);
      wgmma_rs<kTile>(s, frag(ah, ks), b + bo + (b_lo >> 4), 1);
    }
  }
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks) {
    const uint32_t bo = (ks / 4 * kSlabB + 32 * (ks % 4)) >> 4;
    wgmma_rs<kTile>(s, frag(ah, ks), b + bo, Split || ks > 0);
  }
}

// Pᵀ into s, as flash_bwd_dkv_tc forms it: s[4j + e] is (key_a, query qt +
// 8j + 2t + e), s[4j + 2 + e] the same query on key_b; l2[2j + e] is that
// query's lse2. Masked: the tile crosses the block's diagonal (a
// compile-time branch).
template <bool Masked, int Cut>
__device__ __forceinline__ void p_tile(float (&s)[kTile / 2], const float (&l2)[4], float c, int qt, int key_a,
                                       int key_b, int shift, int t) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float l = l2[2 * j + e];
      float pa = fmaf(s[4 * j + e], c, -l), pb = fmaf(s[4 * j + 2 + e], c, -l);
      if constexpr (Cut != kNoExp) {
        pa = exp2_ftz(pa);
        pb = exp2_ftz(pb);
      }
      if constexpr (Masked) {
        const int query = qt + 8 * j + 2 * t + e;
        pa = key_a > query + shift ? 0.f : pa;
        pb = key_b > query + shift ? 0.f : pb;
      }
      s[4 * j + e] = pa;
      s[4 * j + 2 + e] = pb;
    }
}

// A consumer warpgroup's part of every block the CTA walks. Role 0: Sᵀ =
// K·Qᵀ, Pᵀ, handed to consumer 1, and dv += Pᵀ·dO; role 1: dPᵀ = V·dOᵀ,
// dSᵀ = Pᵀ ∘ (dPᵀ − delta) and dk += dSᵀ·Q. Each takes its own 64-row
// operand's hi into registers as the block starts (`ah`, the A fragments of
// the score products) and leaves its lo in shared memory in place of the
// landed rows; then it issues tile t's scores before tile t − 1's products,
// which run under tile t's exps.
template <int Role, bool Causal, bool Split, int Ring, int Cut>
__device__ __forceinline__ void consume(Smem<Ring>& sm, const Walk& walk, float* __restrict__ out, int s_q, int s_kv,
                                        int shift, float scale) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float c = scale * kLog2e;  // P = 2^(s·c − lse2)
  float* lo_rows = Role == 0 ? sm.k_lo : sm.v_lo;
  const uint64_t a_lo = desc_sw128(smem_u32(lo_rows));
  constexpr uint32_t kQLo = offsetof(Scores, q_lo), kDo = offsetof(Scores, dout);
  constexpr uint32_t kDoLo = offsetof(Scores, do_lo) - offsetof(Scores, dout);
  // the products' B operand: dOᵀ (role 0) or Qᵀ (role 1), hi and lo; its row 64 lies 1 KB past its row 0
  const uint32_t tr16 = smem_u32(&sm.tr) >> 4;
  constexpr uint32_t kTHi = Role == 0 ? offsetof(Transposes, dot_hi) : offsetof(Transposes, qt_hi);
  constexpr uint32_t kTLo = Role == 0 ? offsetof(Transposes, dot_lo) : offsetof(Transposes, qt_lo);
  auto release = [&](uint64_t* bar) {
    if (lane == 0) bar_arrive(bar);
  };
  int gt = 0, nb = 0;
  for (int n = 0, bh, r; walk.next(n, bh, r); ++n) {
    const int key0 = r * kRows;
    const int qt0 = Causal ? min(max(key0 - shift, 0), s_q) / kTile * kTile : 0, n_tiles = (s_q - qt0) / kTile;
    const int key_a = key0 + 16 * warp + g, key_b = key_a + 8;  // the two key rows this thread holds
    // causal: the first tiles cross the block's diagonal (a query before one of its keys); the rest are open
    const int reach = key0 + kRows - 1 - shift - qt0;
    const int n_masked = Causal && reach > 0 ? min(n_tiles, (reach + kTile - 1) / kTile) : 0;

    float acc[kD / 2];  // dv (role 0) or dk / scale (role 1)
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    if (n_tiles > 0) {
      bar_wait(&sm.kv_land, nb & 1);
      auto s_ready = [&](int it) { bar_wait(&sm.s_ready[(gt + it) % Ring], ((gt + it) / Ring) & 1); };
      auto t_ready = [&](int it) { bar_wait(&sm.t_ready, (gt + it) & 1); };
      if constexpr (Cut == kLoadsOnly) {
        for (int it = 0; it < n_tiles; ++it) {
          s_ready(it);
          release(&sm.s_empty[(gt + it) % Ring]);
          if (it == n_tiles - 1) release(&sm.kv_empty);
          t_ready(it);
          release(&sm.t_empty);
        }
      } else {
        uint32_t ah[64];
        take_hi<Split>(lo_rows, ah, warp, g, t);
        proxy_fence();
        named_sync(kOwn + Role, 128);

        // causal: a tile's partial sum spans kPart columns (32 in the split
        // instance, whose registers are the tightest; 64 else)
        constexpr int kPart = Causal && Split ? 32 : 64;
        float s[kTile / 2], l2[4], part[kPart / 2];
        uint32_t xh[kTile / 2], xl[kTile / 2];  // Pᵀ's (role 0) or dSᵀ's (role 1) hi and lo
        auto stats = [&](int it) {  // the tile's lse2 (role 0) or delta (role 1) of this thread's queries 8j + 2t + e
          const float(&x)[kTile] = sm.stats[(gt + it) % Ring][Role];
#pragma unroll
          for (int j = 0; j < kTile / 8; ++j) {
            const float2 a = *reinterpret_cast<const float2*>(&x[8 * j + 2 * t]);
            l2[2 * j] = a.x;
            l2[2 * j + 1] = a.y;
          }
        };
        auto scores = [&](int it) {  // Sᵀ (dPᵀ) of tile `it`, issued into the open wgmma group
          if constexpr (Cut == kNoMma) {
#pragma unroll
            for (int i = 0; i < kTile / 2; ++i) s[i] = (Role == 0 ? 0.03125f : 0.015625f) * i;
          } else {
            const uint64_t b = desc_sw128(smem_u32(sm.st[(gt + it) % Ring].q)) + (Role == 0 ? 0 : kDo >> 4);
            issue_st<Split>(s, ah, a_lo, b, Role == 0 ? kQLo : kDoLo);
          }
        };
        // role 0: Pᵀ, into slot (gt + it) % 2 for consumer 1; role 1: dSᵀ from it
        auto form = [&](int it) {
          const int slot = (gt + it) & 1;
          if constexpr (Role == 0) {
            if (Causal && it < n_masked)
              p_tile<true, Cut>(s, l2, c, qt0 + it * kTile, key_a, key_b, shift, t);
            else
              p_tile<false, Cut>(s, l2, c, qt0 + it * kTile, key_a, key_b, shift, t);
            if (gt + it >= 2) named_sync(kPFree + slot, 256);  // consumer 1 has read the slot's last P
            sm.p[slot][0][tid] = make_float4(s[0], s[1], s[2], s[3]);
            sm.p[slot][1][tid] = make_float4(s[4], s[5], s[6], s[7]);
            named_arrive(kPFull + slot, 256);
          } else {
            named_sync(kPFull + slot, 256);
#pragma unroll
            for (int j = 0; j < kTile / 8; ++j) {  // s[4j + e] and s[4j + 2 + e] hold query 8j + 2t + e
              const float4 pv = sm.p[slot][j][tid];
              s[4 * j] = pv.x * (s[4 * j] - l2[2 * j]);
              s[4 * j + 1] = pv.y * (s[4 * j + 1] - l2[2 * j + 1]);
              s[4 * j + 2] = pv.z * (s[4 * j + 2] - l2[2 * j]);
              s[4 * j + 3] = pv.w * (s[4 * j + 3] - l2[2 * j + 1]);
            }
            named_arrive(kPFree + slot, 256);
          }
        };
        // Non-causal: the tile's product into the accumulator, issued into the
        // open wgmma group. Causal: its first kPart columns into the fresh partial sum.
        auto products = [&]() {
          if constexpr (Cut != kNoMma) {
            if constexpr (Causal)
              rs_split<kPart, kTile, Split, kD>(part, xh, xl, tr16, kTHi, kTLo, 0);
            else
              rs_split<kD, kTile, Split>(acc, xh, xl, tr16, kTHi, kTLo);
          }
        };
        // after `products` has landed: causal, the partial sum joins the
        // accumulator in f32 adds, then the other columns kPart at a time
        // likewise (each column's sum as flash_bwd_dkv_tc forms it)
        auto rest = [&]() {
          if constexpr (Cut != kNoMma) {
            if constexpr (Causal) {
              pin(part);
#pragma unroll
              for (int i = 0; i < kPart / 2; ++i) cols<kPart>(acc, 0)[i] += part[i];
#pragma unroll
              for (int h = 1; h < kD / kPart; ++h) {  // rows kPart·h … of the transpose start 16·kPart·h bytes in
                wg_fence();
                rs_split<kPart, kTile, Split, kD>(part, xh, xl, tr16, kTHi + 16 * kPart * h, kTLo + 16 * kPart * h, 0);
                wg_commit();
                wg_wait();
                pin(part);
#pragma unroll
                for (int i = 0; i < kPart / 2; ++i) cols<kPart>(acc, kPart * h)[i] += part[i];
              }
            } else {
              pin(acc);
            }
            pin(xh);
            if constexpr (Split) pin(xl);
          }
        };
        s_ready(0);
        wg_fence();
        scores(0);
        wg_commit();
        wg_wait();
        pin(s);
        stats(0);
        release(&sm.s_empty[gt % Ring]);
        if (n_tiles == 1) release(&sm.kv_empty);
        form(0);
        split_frag<kTile / 2, Split>(s, xh, xl);
        for (int it = 1; it < n_tiles; ++it) {
          s_ready(it);
          wg_fence();
          scores(it);
          wg_commit();
          t_ready(it - 1);  // the producer stores the transposes while the scores run
          wg_fence();
          products();
          wg_commit();
          wait_group<1>();  // the scores; the products may still run
          pin(s);
          stats(it);  // read before the stage is freed, held only while the tile is formed
          release(&sm.s_empty[(gt + it) % Ring]);
          if (it == n_tiles - 1) release(&sm.kv_empty);
          form(it);
          wait_group<0>();
          rest();
          release(&sm.t_empty);
          split_frag<kTile / 2, Split>(s, xh, xl);
        }
        t_ready(n_tiles - 1);
        wg_fence();
        products();
        wg_commit();
        wg_wait();
        rest();
        release(&sm.t_empty);
      }
      gt += n_tiles;
      ++nb;
    }

    const float f = Role == 0 ? 1.f : scale;
    float* ra = out + ((size_t)bh * s_kv + key_a) * kD + 2 * t;
    float* rb = out + ((size_t)bh * s_kv + key_b) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      *reinterpret_cast<float2*>(ra + 8 * j) = make_float2(acc[4 * j] * f, acc[4 * j + 1] * f);
      *reinterpret_cast<float2*>(rb + 8 * j) = make_float2(acc[4 * j + 2] * f, acc[4 * j + 3] * f);
    }
  }
  // consumer 1 freed the last two tiles' slots without a writer waiting: match them
  if constexpr (Role == 0 && Cut != kLoadsOnly)
    for (int x = max(gt - 2, 0); x < gt; ++x) named_sync(kPFree + (x & 1), 256);
}

// dk, dv of k, v [BH, Skv, 128] as flash_bwd_dkv_tc computes them, for
// Hopper (the note at the top). Persistent: grid min(SMs, blocks), kThreads
// threads, sizeof(Smem<Ring>) + 1024 bytes of dynamic shared memory; k, v
// through TMA maps of [BH·Skv, 128] f32 in boxes of 32 columns by 64 rows,
// q and dO through maps of [BH·Sq, 128] in boxes of 32 columns by 16 rows.
template <bool Causal, bool Split, int Ring, int Cut = kFull>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_d128_tc(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int bh_count, int s_q, int s_kv, int shift, float scale) {
  using S = Smem<Ring>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = aligned_smem<S>(smem_raw);
  const Walk walk{bh_count, s_kv / kRows};  // block r of a head: keys r·64 …, the first ones heaviest (causal)

  if (threadIdx.x == 0) {
    bar_init(&sm.kv_land, 1);   // the issuing thread's bar_expect; then the bytes
    bar_init(&sm.kv_empty, 8);  // a consumer warp each, after the block's last scores
    for (int i = 0; i < kRawStages; ++i) bar_init(&sm.raw_full[i], 1);
    for (int i = 0; i < Ring; ++i) {
      bar_init(&sm.s_ready[i], 128);  // every producer thread, after its part of the operands
      bar_init(&sm.s_empty[i], 8);
    }
    bar_init(&sm.t_ready, 128);
    bar_init(&sm.t_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_inc<kConsumerRegs>();
    consume<0, Causal, Split, Ring, Cut>(sm, walk, dv, s_q, s_kv, shift, scale);
    return;
  }
  if (threadIdx.x < 256) {
    regs_inc<kConsumerRegs>();
    consume<1, Causal, Split, Ring, Cut>(sm, walk, dk, s_q, s_kv, shift, scale);
    return;
  }

  // The producer warpgroup. Thread p = 0 lands each tile's Q, dO, lse and
  // delta by TMA into a ring of kRawStages, and each block's K and V into
  // the consumers' rows once their last block's scores are done. The
  // warpgroup stores each tile twice from the landed rows (thread p:
  // queries r0 + 0, 2, 4, 6, columns 4c … 4c + 3): Q's and dO's hi and lo in
  // the swizzled layout into the scores' ring with the tile's lse2 and delta,
  // a tile ahead of Qᵀ's and dOᵀ's hi and lo into the transposes' stage (the
  // four floats of a column are the float4 of positions 4pg … 4pg + 3; the
  // columns are stored in an order turned by (c / 2) % 4, so that the eight
  // lanes of a store phase meet eight banks). The consumers' scores of tile
  // g + 1 then never wait for tile g's transposes, which they read only
  // after them. Blocks without a tile (causal, every query before their
  // keys) are skipped by both sides.
  regs_dec<kProducerRegs>();
  const int p = threadIdx.x - 256, pg = p / 32, c = p % 32;
  const int r0 = (pg >> 1) * 8 + (pg & 1);  // this thread's queries of a tile: r0, r0 + 2, r0 + 4, r0 + 6
  const int turn = (c >> 1) & 3;
  struct Tile {
    int n, bh, key0, qt0, it, n_tiles;  // tile `it` of the n-th block's n_tiles, from query qt0
  };
  auto seek = [&](int n, Tile& x) {  // the first tile of the first block from the n-th on that has one
    for (int bh, r; walk.next(n, bh, r); ++n) {
      const int key0 = r * kRows;
      const int qt0 = Causal ? min(max(key0 - shift, 0), s_q) / kTile * kTile : 0, nt = (s_q - qt0) / kTile;
      if (nt > 0) {
        x = Tile{n, bh, key0, qt0, 0, nt};
        return true;
      }
    }
    return false;
  };
  auto advance = [&](Tile& x) {  // x to its successor in the walk; false after the last tile
    if (++x.it < x.n_tiles) return true;
    return seek(x.n + 1, x);
  };
  // thread 0: the CTA's g-th tile x's Q, dO, lse and delta into raw stage g % kRawStages
  auto land_raw = [&](int g, const Tile& x) {
    if constexpr (Cut != kNoSplit) {
      const int st = g % kRawStages, row = x.bh * s_q + x.qt0 + x.it * kTile;
      bar_expect(&sm.raw_full[st], 2 * kTile * kD * 4 + 2 * kTile * 4);
#pragma unroll
      for (int h = 0; h < kSlabs; ++h) {
        tma_box(sm.raw[st].q + h * kTile * kSlab, map_q, h * kSlab, row, &sm.raw_full[st]);
        tma_box(sm.raw[st].dout + h * kTile * kSlab, map_do, h * kSlab, row, &sm.raw_full[st]);
      }
      bulk_copy(sm.raw_stats[st][0], lse + row, kTile * 4, &sm.raw_full[st]);
      bulk_copy(sm.raw_stats[st][1], delta + row, kTile * 4, &sm.raw_full[st]);
    }
  };
  // the scores' operands of the CTA's g-th tile into ring stage g % Ring
  auto store_scores = [&](int g) {
    const int st = g % Ring, rs = g % kRawStages;
    if (g >= Ring) bar_wait(&sm.s_empty[st], (g / Ring - 1) & 1);
    if constexpr (Cut != kNoSplit) {
      bar_wait(&sm.raw_full[rs], (g / kRawStages) & 1);
      Scores& stage = sm.st[st];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned at = swz<kTile>(r0 + 2 * i, 4 * c);
        float4 hi, lo;
        split4(*reinterpret_cast<const float4*>(&sm.raw[rs].q[at]), hi, lo);
        *reinterpret_cast<float4*>(&stage.q[at]) = hi;
        if constexpr (Split) *reinterpret_cast<float4*>(&stage.q_lo[at]) = lo;
        split4(*reinterpret_cast<const float4*>(&sm.raw[rs].dout[at]), hi, lo);
        *reinterpret_cast<float4*>(&stage.dout[at]) = hi;
        if constexpr (Split) *reinterpret_cast<float4*>(&stage.do_lo[at]) = lo;
      }
      if (p < 16)
        sm.stats[st][0][p] = lse2(sm.raw_stats[rs][0][p]);
      else if (p < 32)
        sm.stats[st][1][p - 16] = sm.raw_stats[rs][1][p - 16];
    }
    proxy_fence();
    bar_arrive(&sm.s_ready[st]);
  };
  // the transposes of one landed [16 x 128] tile x (this thread's rows r0 +
  // 2i, columns 4c …): column d = 4c + (e + turn) % 4, positions 4pg … 4pg + 3
  auto transpose = [&](const float* x, float* t_hi, float* t_lo) {
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = *reinterpret_cast<const float4*>(&x[swz<kTile>(r0 + 2 * i, 4 * c)]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = (e + turn) & 3;
      float4 hi, lo;
      split4(make_float4(at4(v[0], k), at4(v[1], k), at4(v[2], k), at4(v[3], k)), hi, lo);
      const unsigned at = cidx<kD>(4 * c + k, 4 * pg);
      *reinterpret_cast<float4*>(&t_hi[at]) = hi;
      if constexpr (Split) *reinterpret_cast<float4*>(&t_lo[at]) = lo;
    }
  };
  // the products' operands of the CTA's g-th tile, once the consumers have freed the last tile's
  auto store_transposes = [&](int g) {
    if (g >= 1) bar_wait(&sm.t_empty, (g - 1) & 1);
    if constexpr (Cut != kNoSplit) {
      const int rs = g % kRawStages;
      transpose(sm.raw[rs].q, sm.tr.qt_hi, sm.tr.qt_lo);
      transpose(sm.raw[rs].dout, sm.tr.dot_hi, sm.tr.dot_lo);
    }
    proxy_fence();
    bar_arrive(&sm.t_ready);
  };
  int nb = 0;
  // thread 0: block x's K and V into the consumers' rows once their last block's scores are done (the next block's into L2)
  auto land_kv = [&](const Tile& x) {
    if (p == 0) {
      if (nb > 0) bar_wait(&sm.kv_empty, (nb - 1) & 1);
      bar_expect(&sm.kv_land, 2 * kRows * kD * 4);
#pragma unroll
      for (int h = 0; h < kSlabs; ++h) {
        tma_box(sm.k_lo + h * kRows * kSlab, map_k, h * kSlab, x.bh * s_kv + x.key0, &sm.kv_land);
        tma_box(sm.v_lo + h * kRows * kSlab, map_v, h * kSlab, x.bh * s_kv + x.key0, &sm.kv_land);
      }
      Tile after;
      if (seek(x.n + 1, after))
#pragma unroll
        for (int h = 0; h < kSlabs; ++h) {
          tma_prefetch(map_k, h * kSlab, after.bh * s_kv + after.key0);
          tma_prefetch(map_v, h * kSlab, after.bh * s_kv + after.key0);
        }
    }
    ++nb;
  };

  Tile nxt, ahead;  // tiles gt + 1 and gt + kRawStages at step gt
  if (!seek(0, nxt)) return;
  ahead = nxt;
  bool ahead_ok = true;
  for (int g = 0; g < kRawStages && ahead_ok; ++g) {  // the first tiles' rows in flight
    if (p == 0) land_raw(g, ahead);
    ahead_ok = advance(ahead);
  }
  store_scores(0);
  land_kv(nxt);
  bool more = advance(nxt);
  for (int gt = 0;; ++gt) {  // tile gt + 1 is `nxt` where `more`
    if (more) store_scores(gt + 1);
    store_transposes(gt);
    if (more && nxt.it == 0) land_kv(nxt);
    named_sync(kProducerBar, 128);  // raw stage gt % kRawStages is read by every thread: refill it
    if (ahead_ok) {
      if (p == 0) land_raw(gt + kRawStages, ahead);
      ahead_ok = advance(ahead);
    }
    if (!more) return;
    more = advance(nxt);
  }
}

// One launch of the head-dim-128 dk/dv with Ring score stages; the cudaError_t of the launch.
template <bool Causal, bool Split, int Ring = 2, int Cut = kFull>
int launch(const float* q, const float* k, const float* v, const float* dout, const float* lse, const float* delta,
           float* dk, float* dv, int bh, int s_q, int s_kv, int shift, float scale, cudaStream_t st) {
  CUtensorMap mk, mv, mq, mdo;
  int e = hopper_tma::tensor_map_f32_2d(&mk, k, (long long)bh * s_kv, kD, kSlab, kRows);
  if (e == 0) e = hopper_tma::tensor_map_f32_2d(&mv, v, (long long)bh * s_kv, kD, kSlab, kRows);
  if (e == 0) e = hopper_tma::tensor_map_f32_2d(&mq, q, (long long)bh * s_q, kD, kSlab, kTile);
  if (e == 0) e = hopper_tma::tensor_map_f32_2d(&mdo, dout, (long long)bh * s_q, kD, kSlab, kTile);
  int grid = 0;
  if (e == 0) e = hopper_tma::persistent_grid(bh * (s_kv / kRows), &grid);
  if (e != 0) return e;
  return hopper_tma::launch(flash_bwd_dkv_d128_tc<Causal, Split, Ring, Cut>, (int)sizeof(Smem<Ring>) + 1024,
                            dim3(grid), kThreads, st, mk, mv, mq, mdo, lse, delta, dk, dv, bh, s_q, s_kv, shift,
                            scale);
}

}  // namespace bwd128

// ---------------------------------------------------------------------------
// dq at head dim 128 (the note at the top: head dim 128)
// ---------------------------------------------------------------------------
namespace dq128 {

using bwd128::at4;
using bwd128::issue_st;
using bwd128::swz;
using bwd128::take_hi;
using fwd128::wait_group;
using fwd128::Walk;
using hopper_tma::aligned_smem;
using hopper_tma::bar_arrive;
using hopper_tma::bar_expect;
using hopper_tma::bar_init;
using hopper_tma::bar_wait;
using hopper_tma::named_arrive;
using hopper_tma::named_sync;
using hopper_tma::regs_dec;
using hopper_tma::regs_inc;
using hopper_tma::smem_u32;
using hopper_tma::tma_box;
using hopper_tma::tma_prefetch;

constexpr int kD = 128;
constexpr int kRows = 64;           // query rows a block owns
constexpr int kTile = 16;           // keys a tile
constexpr int kThreads = 384;       // consumer warpgroups 0 (S, P) and 1 (dP, dS, dq), then the producer warpgroup
constexpr int kSlab = 32;           // floats a swizzled row (128 bytes): the columns of a slab
constexpr int kSlabs = kD / kSlab;
constexpr int kScoreStages = 2;     // the scores' operands in flight
constexpr int kRawStages = 2;       // tiles of K and V in flight from device memory
constexpr int kSmemLimit = 232448;  // shared memory a block may have
constexpr int kRegisters = 65536;   // registers of an SM
constexpr int kLaunchRegs = 168;    // a thread's registers at __launch_bounds__(384, 1); consumer 0 keeps them
constexpr int kProducerRegs = 48, kConsumerRegs = 240;  // setmaxnreg of the producer and of consumer 1
static_assert(kLaunchRegs == kRegisters / kThreads / 8 * 8, "the registers of a thread at launch");
static_assert(128 * (kProducerRegs + kLaunchRegs + kConsumerRegs) <= kThreads * kLaunchRegs,
              "setmaxnreg over the registers the CTA is launched with");
static_assert(kRows == bwd128::kRows && kTile == bwd128::kTile, "issue_st's operands: 64 rows by 16");
// named barriers (0 is __syncthreads): a tile's P handed from consumer 0 to
// consumer 1 through slot s (kPFull + s: written; kPFree + s: read), each
// consumer's own (kOwn + warpgroup), the producer's
constexpr int kPFull = 1, kPFree = 3, kOwn = 5, kProducerBar = 7;

// A tile's operands of S and dP: K's and V's hi and lo, each four slabs of
// 16 keys by 32 floats with the 128-byte swizzle (`desc_sw128`)
struct Scores {
  float k[kTile * kD], k_lo[kTile * kD];
  float v[kTile * kD], v_lo[kTile * kD];
};
static_assert(sizeof(Scores) == 32768, "a stage keeps its slabs 1 KB aligned");

// A tile of K and V as the TMA lands them (the slabs of `Scores`' layout)
struct Raw {
  float k[kTile * kD], v[kTile * kD];
};

// A tile's operand of dq += dS·K: Kᵀ's hi and lo, D rows by 16 keys with the
// keys of every 8 in the order 0, 2, 4, 6, 1, 3, 5, 7 (`cidx<kD>`), as
// `rs_split` reads them
struct Transposes {
  float kt_hi[kD * kTile], kt_lo[kD * kTile];
};

template <int Ring>
struct Smem {
  alignas(1024) float q_lo[kRows * kD];   // Q as the TMA landed it (four slabs of 64 rows by 32 floats), then Q − hi
  alignas(1024) float do_lo[kRows * kD];  // dO likewise
  alignas(1024) Scores st[kScoreStages];  // the scores' operands
  alignas(1024) Raw raw[kRawStages];      // K and V as landed
  Transposes tr[Ring];                    // the product's operand: a ring of Ring stages
  float4 p[2][2][128];                    // a tile's P, consumer 0's thread i to consumer 1's: [slot][half][i]
  uint64_t qd_land, qd_empty, raw_full[kRawStages];
  uint64_t s_ready[kScoreStages], s_empty[kScoreStages], t_ready[Ring], t_empty[Ring];
};
// The plans' bytes (the launch asks for 1 KB more, to align the slabs): two
// transposes stages (shipped), three (chip_sweep.py flash_f32). A third
// score stage does not fit beside them; one transposes stage deadlocks
// (consumer 0 would wait for the product of the tile before, which waits
// for this tile's P).
static_assert(sizeof(Smem<2>) == 205824 && sizeof(Smem<2>) + 1024 <= kSmemLimit, "two stages over 227 KB");
static_assert(sizeof(Smem<3>) == 222208 && sizeof(Smem<3>) + 1024 <= kSmemLimit, "three stages over 227 KB");
static_assert(sizeof(Smem<2>) + sizeof(Scores) + 1024 > kSmemLimit, "a third score stage would fit");

// the first row of the walk's block r (causal: the last rows first)
template <bool Causal>
__device__ __forceinline__ int block_row0(const Walk& walk, int r) {
  return (Causal ? walk.blocks - 1 - r : r) * kRows;
}

// the tiles of a block from row0: keys [0, key_end) can be seen by its rows
template <bool Causal>
__device__ __forceinline__ int tiles_of(int row0, int shift, int s_kv) {
  return ((Causal ? key_end<kRows>(row0, shift, s_kv) : s_kv) + kTile - 1) / kTile;
}

// Kᵀ's hi and lo of a tile from its score stage (K's hi and lo as the
// producer split them: the values a split of the landed rows gives), by
// thread p of a warpgroup: keys r0 + 0, 2, 4, 6 (r0 from the warp), columns
// 4c … 4c + 3 (c the lane); column d = 4c + (e + turn) % 4 holds the float4
// of positions 4pg … 4pg + 3, the columns stored in an order turned by (c /
// 2) % 4, so that the eight lanes of a store phase meet eight banks.
template <bool Split>
__device__ __forceinline__ void store_kt(const Scores& st, Transposes& tr, int p) {
  const int pg = p / 32, c = p % 32;
  const int r0 = (pg >> 1) * 8 + (pg & 1), turn = (c >> 1) & 3;
  float4 hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned at = swz<kTile>(r0 + 2 * i, 4 * c);
    hi[i] = *reinterpret_cast<const float4*>(&st.k[at]);
    if constexpr (Split) lo[i] = *reinterpret_cast<const float4*>(&st.k_lo[at]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = (e + turn) & 3;
    const unsigned at = cidx<kD>(4 * c + k, 4 * pg);
    *reinterpret_cast<float4*>(&tr.kt_hi[at]) = make_float4(at4(hi[0], k), at4(hi[1], k), at4(hi[2], k), at4(hi[3], k));
    if constexpr (Split)
      *reinterpret_cast<float4*>(&tr.kt_lo[at]) = make_float4(at4(lo[0], k), at4(lo[1], k), at4(lo[2], k), at4(lo[3], k));
  }
}

// P into s, as flash_bwd_dq_tc forms it: s[4j + e] is (row_a, key kt + 8j +
// 2t + e), s[4j + 2 + e] the same key on row_b; l_a, l_b are the rows'
// lse2. Masked: the tile crosses the block's diagonal (a compile-time
// branch).
template <bool Masked, int Cut>
__device__ __forceinline__ void p_tile(float (&s)[kTile / 2], float l_a, float l_b, float c, int kt, int row_a,
                                       int row_b, int shift, int t) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float pa = fmaf(s[4 * j + e], c, -l_a), pb = fmaf(s[4 * j + 2 + e], c, -l_b);
      if constexpr (Cut != kNoExp) {
        pa = exp2_ftz(pa);
        pb = exp2_ftz(pb);
      }
      if constexpr (Masked) {
        const int key = kt + 8 * j + 2 * t + e;
        pa = key > row_a + shift ? 0.f : pa;
        pb = key > row_b + shift ? 0.f : pb;
      }
      s[4 * j + e] = pa;
      s[4 * j + 2 + e] = pb;
    }
}

// A consumer warpgroup's part of every block the CTA walks. Role 0: S =
// Q·Kᵀ and P, handed to consumer 1, and each tile's Kᵀ for consumer 1's
// product, copied from the score stage while its scores run; role 1: dP =
// dO·Vᵀ, dS = P ∘ (dP − delta) and dq += dS·K. Each takes its own 64-row
// operand's hi into registers as the block starts (`ah`, the A fragments of
// its score product) and leaves its lo in shared memory in place of the
// landed rows. Role 1 issues tile t's dP before tile t − 1's dS·K, which
// runs under tile t's dS.
template <int Role, bool Causal, bool Split, int Ring, int Cut>
__device__ __forceinline__ void consume(Smem<Ring>& sm, const Walk& walk, const float* __restrict__ lse,
                                        const float* __restrict__ delta, float* __restrict__ dq, int s_q, int s_kv,
                                        int shift, float scale) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float c = scale * kLog2e;  // P = 2^(s·c − lse2)
  float* lo_rows = Role == 0 ? sm.q_lo : sm.do_lo;
  const uint64_t a_lo = desc_sw128(smem_u32(lo_rows));
  // the scores' B operand in a stage: K (role 0) or V (role 1), its hi, and its lo kBLo bytes past it
  constexpr uint32_t kB = Role == 0 ? offsetof(Scores, k) : offsetof(Scores, v);
  constexpr uint32_t kBLo = (Role == 0 ? offsetof(Scores, k_lo) : offsetof(Scores, v_lo)) - kB;
  constexpr uint32_t kTHi = offsetof(Transposes, kt_hi), kTLo = offsetof(Transposes, kt_lo);
  auto release = [&](uint64_t* bar) {
    if (lane == 0) bar_arrive(bar);
  };
  int gt = 0, nb = 0;
  for (int n = 0, bh, r; walk.next(n, bh, r); ++n) {
    const int row0 = block_row0<Causal>(walk, r), n_tiles = tiles_of<Causal>(row0, shift, s_kv);
    const int row_a = row0 + 16 * warp + g, row_b = row_a + 8;  // the two rows this thread holds
    // the tiles no row of the block masks (causal: those wholly below its diagonal)
    const int n_open = Causal ? min(n_tiles, max(row0 + shift + 1, 0) / kTile) : n_tiles;

    float acc[kD / 2];  // dq / scale (role 1)
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    if (n_tiles > 0) {
      // the rows' lse2 (role 0) or delta (role 1)
      const float* stats = (Role == 0 ? lse : delta) + (size_t)bh * s_q;
      float st_a = __ldg(stats + row_a), st_b = __ldg(stats + row_b);
      if constexpr (Role == 0) {
        st_a = lse2(st_a);
        st_b = lse2(st_b);
      }
      bar_wait(&sm.qd_land, nb & 1);
      auto s_ready = [&](int it) {
        bar_wait(&sm.s_ready[(gt + it) % kScoreStages], ((gt + it) / kScoreStages) & 1);
      };
      auto t_ready = [&](int it) { bar_wait(&sm.t_ready[(gt + it) % Ring], ((gt + it) / Ring) & 1); };
      auto scores_done = [&](int it) {  // the tile's stage, and after the block's last tile its rows, are free
        release(&sm.s_empty[(gt + it) % kScoreStages]);
        if (it == n_tiles - 1) release(&sm.qd_empty);
      };
      // role 0: tile `it`'s Kᵀ from its score stage into its transposes stage,
      // once consumer 1 has freed that stage's last tile (Ring tiles back;
      // the loads-only cut stores nothing)
      auto transposes = [&](int it) {
        const int x = gt + it, ts = x % Ring;
        if (x >= Ring) bar_wait(&sm.t_empty[ts], (x / Ring - 1) & 1);
        if constexpr (Cut != kLoadsOnly) {
          store_kt<Split>(sm.st[x % kScoreStages], sm.tr[ts], tid);
          proxy_fence();
        }
        bar_arrive(&sm.t_ready[ts]);
      };
      if constexpr (Cut == kLoadsOnly) {
        for (int it = 0; it < n_tiles; ++it) {
          s_ready(it);
          if constexpr (Role == 0) {
            transposes(it);
            scores_done(it);
          } else {
            scores_done(it);
            t_ready(it);
            release(&sm.t_empty[(gt + it) % Ring]);
          }
        }
      } else {
        uint32_t ah[64];
        take_hi<Split>(lo_rows, ah, warp, g, t);
        proxy_fence();
        named_sync(kOwn + Role, 128);

        float s[kTile / 2];
        auto scores = [&](int it) {  // S (dP) of tile `it`, issued into the open wgmma group
          if constexpr (Cut == kNoMma) {
#pragma unroll
            for (int i = 0; i < kTile / 2; ++i) s[i] = (Role == 0 ? 0.03125f : 0.015625f) * i;
          } else {
            const uint64_t b = desc_sw128(smem_u32(sm.st[(gt + it) % kScoreStages].k)) + (kB >> 4);
            issue_st<Split>(s, ah, a_lo, b, kBLo);
          }
        };
        if constexpr (Role == 0) {
          for (int it = 0; it < n_tiles; ++it) {
            s_ready(it);
            wg_fence();
            scores(it);
            wg_commit();
            transposes(it);  // under the scores; consumer 1 reads this Kᵀ a tile later
            wg_wait();
            pin(s);
            scores_done(it);
            if (Causal && it >= n_open)
              p_tile<true, Cut>(s, st_a, st_b, c, it * kTile, row_a, row_b, shift, t);
            else
              p_tile<false, Cut>(s, st_a, st_b, c, it * kTile, row_a, row_b, shift, t);
            const int slot = (gt + it) & 1;
            if (gt + it >= 2) named_sync(kPFree + slot, 256);  // consumer 1 has read the slot's last P
            sm.p[slot][0][tid] = make_float4(s[0], s[1], s[2], s[3]);
            sm.p[slot][1][tid] = make_float4(s[4], s[5], s[6], s[7]);
            named_arrive(kPFull + slot, 256);
          }
        } else {
          float part[Causal ? kD / 2 : 1];  // causal: a tile's product, summed apart
          uint32_t xh[kTile / 2], xl[kTile / 2];  // dS's hi and lo
          auto form = [&](int it) {  // dS of tile `it` from the P in slot (gt + it) % 2
            const int slot = (gt + it) & 1;
            named_sync(kPFull + slot, 256);
#pragma unroll
            for (int j = 0; j < kTile / 8; ++j) {  // s[4j + e] and s[4j + 2 + e] hold key 8j + 2t + e
              const float4 pv = sm.p[slot][j][tid];
              s[4 * j] = pv.x * (s[4 * j] - st_a);
              s[4 * j + 1] = pv.y * (s[4 * j + 1] - st_a);
              s[4 * j + 2] = pv.z * (s[4 * j + 2] - st_b);
              s[4 * j + 3] = pv.w * (s[4 * j + 3] - st_b);
            }
            named_arrive(kPFree + slot, 256);
          };
          // tile `it`'s Kᵀ stage: descriptor base (shared address / 16); its row 64 lies 1 KB past its row 0
          auto tr16 = [&](int it) { return smem_u32(&sm.tr[(gt + it) % Ring]) >> 4; };
          // tile `it`'s product, issued into the open wgmma group: into the
          // accumulator (non-causal) or a fresh partial sum (causal)
          auto products = [&](int it) {
            if constexpr (Cut != kNoMma) {
              if constexpr (Causal)
                rs_split<kD, kTile, Split>(part, xh, xl, tr16(it), kTHi, kTLo, 0);
              else
                rs_split<kD, kTile, Split>(acc, xh, xl, tr16(it), kTHi, kTLo);
            }
          };
          // after `products` has landed: causal, the partial sum joins the
          // accumulator in f32 adds (flash_bwd_dq_tc's order); Kᵀ's stage is free
          auto rest = [&](int it) {
            if constexpr (Cut != kNoMma) {
              if constexpr (Causal) {
                pin(part);
#pragma unroll
                for (int i = 0; i < kD / 2; ++i) acc[i] += part[i];
              } else {
                pin(acc);
              }
              pin(xh);
              if constexpr (Split) pin(xl);
            }
            release(&sm.t_empty[(gt + it) % Ring]);
          };
          s_ready(0);
          wg_fence();
          scores(0);
          wg_commit();
          wg_wait();
          pin(s);
          scores_done(0);
          form(0);
          split_frag<kTile / 2, Split>(s, xh, xl);
          for (int it = 1; it < n_tiles; ++it) {
            s_ready(it);
            wg_fence();
            scores(it);
            wg_commit();
            t_ready(it - 1);  // consumer 0 stored that tile's Kᵀ under its scores
            wg_fence();
            products(it - 1);
            wg_commit();
            wait_group<1>();  // the scores; the product may still run
            pin(s);
            scores_done(it);
            form(it);
            wait_group<0>();
            rest(it - 1);
            split_frag<kTile / 2, Split>(s, xh, xl);
          }
          t_ready(n_tiles - 1);
          wg_fence();
          products(n_tiles - 1);
          wg_commit();
          wg_wait();
          rest(n_tiles - 1);
        }
      }
      gt += n_tiles;
      ++nb;
    }

    if constexpr (Role == 1) {
      float* ra = dq + ((size_t)bh * s_q + row_a) * kD + 2 * t;
      float* rb = dq + ((size_t)bh * s_q + row_b) * kD + 2 * t;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<float2*>(ra + 8 * j) = make_float2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
        *reinterpret_cast<float2*>(rb + 8 * j) = make_float2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
      }
    }
  }
  // consumer 1 freed the last two tiles' slots without a writer waiting: match them
  if constexpr (Role == 0 && Cut != kLoadsOnly)
    for (int x = max(gt - 2, 0); x < gt; ++x) named_sync(kPFree + (x & 1), 256);
}

// dq of q, dO [BH, Sq, 128] against k, v [BH, Skv, 128] as flash_bwd_dq_tc
// computes it, for Hopper (the note at the top). Persistent: grid min(SMs,
// blocks), kThreads threads, sizeof(Smem<Ring>) + 1024 bytes of dynamic
// shared memory; q and dO through TMA maps of [BH·Sq, 128] f32 in boxes of
// 32 columns by 64 rows, k and v through maps of [BH·Skv, 128] in boxes of 32
// columns by 16 rows.
template <bool Causal, bool Split, int Ring, int Cut = kFull>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_d128_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
                     int bh_count, int s_q, int s_kv, int shift, float scale) {
  using S = Smem<Ring>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = aligned_smem<S>(smem_raw);
  const Walk walk{bh_count, s_q / kRows};  // block r of a head: rows (causal: from the last) r·64 …

  if (threadIdx.x == 0) {
    bar_init(&sm.qd_land, 1);   // the issuing thread's bar_expect; then the bytes
    bar_init(&sm.qd_empty, 8);  // a consumer warp each, after the block's last scores
    for (int i = 0; i < kRawStages; ++i) bar_init(&sm.raw_full[i], 1);
    for (int i = 0; i < kScoreStages; ++i) {
      bar_init(&sm.s_ready[i], 128);  // every producer thread, after its part of the operands
      bar_init(&sm.s_empty[i], 8);
    }
    for (int i = 0; i < Ring; ++i) {
      bar_init(&sm.t_ready[i], 128);  // every consumer 0 thread, after its part of Kᵀ
      bar_init(&sm.t_empty[i], 4);    // consumer 1's warps, after the product
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    consume<0, Causal, Split, Ring, Cut>(sm, walk, lse, delta, dq, s_q, s_kv, shift, scale);
    return;
  }
  if (threadIdx.x < 256) {
    regs_inc<kConsumerRegs>();
    consume<1, Causal, Split, Ring, Cut>(sm, walk, lse, delta, dq, s_q, s_kv, shift, scale);
    return;
  }

  // The producer warpgroup. Thread p = 0 lands each tile's K and V by TMA
  // into a ring of kRawStages, and each block's Q and dO into the
  // consumers' rows once their last block's scores are done. The warpgroup
  // stores each tile's K's and V's hi and lo in the swizzled layout into the
  // scores' ring (thread p: keys r0 + 0, 2, 4, 6, columns 4c … 4c + 3);
  // consumer 0 transposes K from there. Blocks without a tile (causal, every
  // key after their rows) are skipped by both sides.
  regs_dec<kProducerRegs>();
  const int p = threadIdx.x - 256, pg = p / 32, c = p % 32;
  const int r0 = (pg >> 1) * 8 + (pg & 1);  // this thread's keys of a tile: r0, r0 + 2, r0 + 4, r0 + 6
  struct Tile {
    int n, bh, row0, it, n_tiles;  // tile `it` of the n-th block's n_tiles
  };
  auto seek = [&](int n, Tile& x) {  // the first tile of the first block from the n-th on that has one
    for (int bh, r; walk.next(n, bh, r); ++n) {
      const int row0 = block_row0<Causal>(walk, r), nt = tiles_of<Causal>(row0, shift, s_kv);
      if (nt > 0) {
        x = Tile{n, bh, row0, 0, nt};
        return true;
      }
    }
    return false;
  };
  auto advance = [&](Tile& x) {  // x to its successor in the walk; false after the last tile
    if (++x.it < x.n_tiles) return true;
    return seek(x.n + 1, x);
  };
  // thread 0: the CTA's g-th tile x's K and V into raw stage g % kRawStages
  auto land_raw = [&](int g, const Tile& x) {
    if constexpr (Cut != kNoSplit) {
      const int st = g % kRawStages, row = x.bh * s_kv + x.it * kTile;
      bar_expect(&sm.raw_full[st], 2 * kTile * kD * 4);
#pragma unroll
      for (int h = 0; h < kSlabs; ++h) {
        tma_box(sm.raw[st].k + h * kTile * kSlab, map_k, h * kSlab, row, &sm.raw_full[st]);
        tma_box(sm.raw[st].v + h * kTile * kSlab, map_v, h * kSlab, row, &sm.raw_full[st]);
      }
    }
  };
  // the scores' operands of the CTA's g-th tile into score stage g % kScoreStages
  auto store_scores = [&](int g) {
    const int st = g % kScoreStages, rs = g % kRawStages;
    if (g >= kScoreStages) bar_wait(&sm.s_empty[st], (g / kScoreStages - 1) & 1);
    if constexpr (Cut != kNoSplit) {
      bar_wait(&sm.raw_full[rs], (g / kRawStages) & 1);
      Scores& stage = sm.st[st];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned at = swz<kTile>(r0 + 2 * i, 4 * c);
        float4 hi, lo;
        split4(*reinterpret_cast<const float4*>(&sm.raw[rs].k[at]), hi, lo);
        *reinterpret_cast<float4*>(&stage.k[at]) = hi;
        if constexpr (Split) *reinterpret_cast<float4*>(&stage.k_lo[at]) = lo;
        split4(*reinterpret_cast<const float4*>(&sm.raw[rs].v[at]), hi, lo);
        *reinterpret_cast<float4*>(&stage.v[at]) = hi;
        if constexpr (Split) *reinterpret_cast<float4*>(&stage.v_lo[at]) = lo;
      }
    }
    proxy_fence();
    bar_arrive(&sm.s_ready[st]);
  };
  int nb = 0;
  // thread 0: block x's Q and dO into the consumers' rows once their last block's scores are done (the next block's into L2)
  auto land_qd = [&](const Tile& x) {
    if (p == 0) {
      if (nb > 0) bar_wait(&sm.qd_empty, (nb - 1) & 1);
      bar_expect(&sm.qd_land, 2 * kRows * kD * 4);
#pragma unroll
      for (int h = 0; h < kSlabs; ++h) {
        tma_box(sm.q_lo + h * kRows * kSlab, map_q, h * kSlab, x.bh * s_q + x.row0, &sm.qd_land);
        tma_box(sm.do_lo + h * kRows * kSlab, map_do, h * kSlab, x.bh * s_q + x.row0, &sm.qd_land);
      }
      Tile after;
      if (seek(x.n + 1, after))
#pragma unroll
        for (int h = 0; h < kSlabs; ++h) {
          tma_prefetch(map_q, h * kSlab, after.bh * s_q + after.row0);
          tma_prefetch(map_do, h * kSlab, after.bh * s_q + after.row0);
        }
    }
    ++nb;
  };

  Tile nxt, ahead;  // tiles g and g + kRawStages at step g
  if (!seek(0, nxt)) return;
  ahead = nxt;
  bool ahead_ok = true;
  for (int g = 0; g < kRawStages && ahead_ok; ++g) {  // the first tiles' rows in flight
    if (p == 0) land_raw(g, ahead);
    ahead_ok = advance(ahead);
  }
  land_qd(nxt);
  for (int g = 0;; ++g) {  // tile g is `nxt`
    store_scores(g);
    named_sync(kProducerBar, 128);  // raw stage g % kRawStages is read by every thread: refill it
    if (ahead_ok) {
      if (p == 0) land_raw(g + kRawStages, ahead);
      ahead_ok = advance(ahead);
    }
    if (!advance(nxt)) return;
    if (nxt.it == 0) land_qd(nxt);
  }
}

// One launch of the head-dim-128 dq with Ring transposes stages; the cudaError_t of the launch.
template <bool Causal, bool Split, int Ring = 2, int Cut = kFull>
int launch(const float* q, const float* k, const float* v, const float* dout, const float* lse, const float* delta,
           float* dq, int bh, int s_q, int s_kv, int shift, float scale, cudaStream_t st) {
  CUtensorMap mq, mdo, mk, mv;
  int e = hopper_tma::tensor_map_f32_2d(&mq, q, (long long)bh * s_q, kD, kSlab, kRows);
  if (e == 0) e = hopper_tma::tensor_map_f32_2d(&mdo, dout, (long long)bh * s_q, kD, kSlab, kRows);
  if (e == 0) e = hopper_tma::tensor_map_f32_2d(&mk, k, (long long)bh * s_kv, kD, kSlab, kTile);
  if (e == 0) e = hopper_tma::tensor_map_f32_2d(&mv, v, (long long)bh * s_kv, kD, kSlab, kTile);
  int grid = 0;
  if (e == 0) e = hopper_tma::persistent_grid(bh * (s_q / kRows), &grid);
  if (e != 0) return e;
  return hopper_tma::launch(flash_bwd_dq_d128_tc<Causal, Split, Ring, Cut>, (int)sizeof(Smem<Ring>) + 1024,
                            dim3(grid), kThreads, st, mq, mdo, mk, mv, lse, delta, dq, bh, s_q, s_kv, shift, scale);
}

}  // namespace dq128

// ---------------------------------------------------------------------------
// The one-pass dk/dv up to head dim 64 (the note at the top: one pass)
// ---------------------------------------------------------------------------
namespace onepass {

using fwd128::Walk;
using hopper_tma::aligned_smem;
using hopper_tma::bar_arrive;
using hopper_tma::bar_expect;
using hopper_tma::bar_init;
using hopper_tma::bar_wait;
using hopper_tma::bulk_copy;
using hopper_tma::named_sync;
using hopper_tma::regs_dec;
using hopper_tma::regs_inc;
using hopper_tma::smem_u32;

constexpr int kSmemLimit = 232448;  // shared memory a block may have
constexpr int kSmemSm = 233472;     // shared memory of an SM (1 KB of it reserved a block)
constexpr int kRegisters = 65536;   // registers of an SM
constexpr int kThreads = 384;       // consumer warpgroups 0 and 1, then the producer warpgroup
constexpr int kProducers = 128;
// a thread's registers at __launch_bounds__(384, ctas): 168 at one CTA an SM, 80 at two
constexpr int launch_regs(int ctas) { return kRegisters / (kThreads * ctas) / 8 * 8; }
// setmaxnreg of the producer and the consumers within the CTA's registers
constexpr bool regs_fit(int ctas, int producer, int consumer) {
  return producer % 8 == 0 && consumer % 8 == 0 && producer >= 24 &&
         kProducers * producer + 256 * consumer <= kThreads * launch_regs(ctas);
}
// a plan's shared memory (the launch asks for 1 KB more, to align) fits `ctas` CTAs an SM
constexpr bool smem_fits(int ctas, size_t bytes) {
  return bytes + 1024 <= kSmemLimit && ctas * (bytes + 1024 + 1024) <= kSmemSm;
}
// named barriers (0 is __syncthreads): each producer chain's (kProducerBar
// + chain); each consumer warpgroup's own (kOwn + warpgroup)
constexpr int kProducerBar = 1, kOwn = 3;

// x rounded to TF32 (hi) component by component
__device__ __forceinline__ float4 tf32_4(float4 x) {
  return make_float4(__uint_as_float(tf32(x.x)), __uint_as_float(tf32(x.y)), __uint_as_float(tf32(x.z)),
                     __uint_as_float(tf32(x.w)));
}

// A warpgroup's 64 rows of a landed row-major [R x D] block (from `rows`),
// rounded into the hi of a 64-row operand (`cidx<64>`), by the warpgroup's
// thread `tid`
template <int D>
__device__ __forceinline__ void form_hi(const float* rows, float* hi, int tid) {
#pragma unroll
  for (int n = 0; n < 64 * D / 4 / 128; ++n) {
    const int i = tid + n * 128, r = i % 64, c4 = i / 64;
    *reinterpret_cast<float4*>(&hi[cidx<64>(r, 4 * c4)]) =
        tf32_4(*reinterpret_cast<const float4*>(&rows[r * D + 4 * c4]));
  }
}

// The dk/dv's plan by head dim
template <int D>
struct DkvPlan {
  static_assert(D == 16 || D == 32 || D == 64, "D = 128 runs bwd128");
  // CTAs an SM: two at D = 16, where a consumer's registers (88) hold a tile
  // at a time; above, one
  static constexpr int kCtas = D == 16 ? 2 : 1;
  static constexpr int kRows = 128;                // key rows a block: consumer warpgroups 0 and 1
  static constexpr int kTile = Plan<D>::kDkvTile;  // queries a tile: flash_bwd_dkv_tc's
  static constexpr int kKv = D == 64 ? 1 : 2;      // blocks' K and V landed ahead
  // Q/dO tiles in flight from device memory (34 KB at D = 16)
  static constexpr int kRaw = D == 64 ? 1 : 8;
  // producer chains, each landing and storing every kChains-th tile: two
  // (one at D = 64, a single raw stage), as a chain takes ~1 µs a tile
  static constexpr int kChains = D == 64 ? 1 : 2;
  static_assert(kRaw % kChains == 0, "a chain's raw stages");
  static constexpr int kRing = D == 64 ? 2 : 3;  // operand stages
  static constexpr int kProducerRegs = kCtas == 2 ? 64 : 88, kConsumerRegs = kCtas == 2 ? 88 : 208;  // setmaxnreg
  static_assert(regs_fit(kCtas, kProducerRegs, kConsumerRegs), "setmaxnreg over the CTA's registers");
};

template <int D>
struct DkvSmem {
  using P = DkvPlan<D>;
  static constexpr int T = P::kTile;
  struct Raw {  // a tile of Q and dO as landed, row-major, and its lse and delta
    float q[T * D], dout[T * D], stats[2][T];
  };
  struct Stage {  // its operands: Q's and dO's hi (`cidx<T>`), Qᵀ's and dOᵀ's hi (`cidx<D>`, queries permuted)
    float q[T * D], dout[T * D], qt[D * T], dot[D * T];
    float lse2[T], delta[T];
  };
  alignas(128) float kv[P::kKv][2][P::kRows * D];  // a block's K and V as landed
  alignas(128) float kv_hi[2][2][64 * D];          // each warpgroup's K and V hi, operand layout
  alignas(128) Raw raw[P::kRaw];
  alignas(128) Stage st[P::kRing];
  uint64_t kv_full[P::kKv], kv_empty[P::kKv], ready[P::kRing], empty[P::kRing];
};
static_assert(sizeof(DkvSmem<16>) == 109440 && smem_fits(2, sizeof(DkvSmem<16>)), "two CTAs an SM");
static_assert(sizeof(DkvSmem<32>) == 215936 && smem_fits(1, sizeof(DkvSmem<32>)), "over 227 KB");
static_assert(sizeof(DkvSmem<64>) == 213888 && smem_fits(1, sizeof(DkvSmem<64>)), "over 227 KB");

// The one-pass dk, dv of k, v [BH, Skv, D] from q, dO [BH, Sq, D] and lse,
// delta [BH, Sq], D up to 64, in flash_bwd_dkv_tc's order of sums (the note
// at the top: one pass). Persistent: grid min(blocks, kCtas · SMs), kThreads
// threads, sizeof(DkvSmem<D>) + 1024 bytes of dynamic shared memory; a tile
// at a time.
template <int D, bool Causal, int Cut>
__global__ void __launch_bounds__(kThreads, DkvPlan<D>::kCtas)
flash_bwd_dkv_1p_tc(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int bh_count, int s_q, int s_kv, int shift,
                    float scale) {
  using P = DkvPlan<D>;
  using S = DkvSmem<D>;
  constexpr int kRows = P::kRows, T = P::kTile, kRing = P::kRing, kRaw = P::kRaw, kKv = P::kKv;
  constexpr int kChains = P::kChains, kChain = kProducers / kChains;  // producer chains, threads a chain
  extern __shared__ unsigned char smem_raw[];
  S& sm = aligned_smem<S>(smem_raw);
  const Walk walk{bh_count, s_kv / kRows};  // block r of a head: keys r·128 …, the first ones heaviest (causal)

  if (threadIdx.x == 0) {
    for (int i = 0; i < kKv; ++i) {
      bar_init(&sm.kv_full[i], 1);   // the issuing thread's bar_expect; then the bytes
      bar_init(&sm.kv_empty[i], 8);  // a consumer warp each, once its warpgroup has formed its K and V
    }
    for (int i = 0; i < kRing; ++i) {
      bar_init(&sm.ready[i], kChain / 32);  // a warp of the tile's chain each, after its part
      bar_init(&sm.empty[i], 8);            // a consumer warp each, after the tile's products
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a block's first query tile (causal: queries before key0 − shift see none of its keys)
  auto first_tile = [&](int key0) { return Causal ? min(max(key0 - shift, 0), s_q) / T * T : 0; };

  if (threadIdx.x >= 256) {
    regs_dec<P::kProducerRegs>();
    // The producer warpgroup, in kChains chains that take the tiles in turn.
    // Thread p = 0 lands the first block's K and V by bulk copy (kKv > 1),
    // and the first thread of the chain that takes a block's first tile those
    // of the block kKv − 1 ahead; every thread of a chain lands its part of
    // each of the chain's query tiles (Q, dO, lse, delta) by cp.async,
    // kRaw / kChains − 1 of them ahead, and stores its part of each landed
    // tile's operands into the ring as the consumers free it: Q's and dO's hi
    // in operand layout, Qᵀ's and dOᵀ's hi with the queries of every 8
    // permuted 0, 2, 4, 6, 1, 3, 5, 7 (as `rs_split` reads them), the tile's
    // lse2 and delta. Blocks without a tile (causal, every query before
    // their keys) are skipped by both sides.
    const int p = threadIdx.x - 256, h = p / kChain, hp = p % kChain;
    struct Tile {
      int n, b, bh, key0, qt0, it, n_tiles;  // tile `it` of the n-th block (the b-th with a tile), from query qt0
    };
    auto seek = [&](int n, int b, Tile& x) {  // the first tile of the first block from the n-th on that has one
      for (int bh, r; walk.next(n, bh, r); ++n) {
        const int key0 = r * kRows, qt0 = first_tile(key0), nt = (s_q - qt0) / T;
        if (nt > 0) {
          x = Tile{n, b, bh, key0, qt0, 0, nt};
          return true;
        }
      }
      return false;
    };
    auto advance = [&](Tile& x) { return ++x.it < x.n_tiles || seek(x.n + 1, x.b + 1, x); };
    auto step = [&](Tile& x) {  // x to the chain's next tile, kChains on
      for (int i = 0; i < kChains; ++i)
        if (!advance(x)) return false;
      return true;
    };
    // the b-th block's K and V into buffer b % kKv, once block b − kKv's consumers have formed theirs
    auto land_kv = [&](int b, const Tile& x) {
      if (b >= kKv) bar_wait(&sm.kv_empty[b % kKv], ((b - kKv) / kKv) & 1);
      if constexpr (Cut == kNoSplit) {
        bar_arrive(&sm.kv_full[b % kKv]);
      } else {
        const size_t row = (size_t)x.bh * s_kv + x.key0;
        bar_expect(&sm.kv_full[b % kKv], 2 * kRows * D * 4);
        bulk_copy(sm.kv[b % kKv][0], k + row * D, kRows * D * 4, &sm.kv_full[b % kKv]);
        bulk_copy(sm.kv[b % kKv][1], v + row * D, kRows * D * 4, &sm.kv_full[b % kKv]);
      }
    };
    // this thread's 16-byte chunks of tile x's Q, dO, lse and delta into raw stage g % kRaw
    auto land_tile = [&](int g, const Tile& x) {
      if constexpr (Cut != kNoSplit) {
        typename S::Raw& raw = sm.raw[g % kRaw];
        const size_t row = (size_t)x.bh * s_q + x.qt0 + x.it * T;
#pragma unroll
        for (int n = 0; n < T * D / 4 / kChain; ++n) {
          const int i = hp + n * kChain;
          cp_async16(&raw.q[4 * i], q + row * D + 4 * i);
          cp_async16(&raw.dout[4 * i], dout + row * D + 4 * i);
        }
        if (hp < T / 4)
          cp_async16(&raw.stats[0][4 * hp], lse + row + 4 * hp);
        else if (hp < T / 2)
          cp_async16(&raw.stats[1][4 * (hp - T / 4)], delta + row + 4 * (hp - T / 4));
      }
    };
    // the landed Q and dO of a tile into their operands and transposes, as
    // flash_bwd_dkv_tc's split_both without the lo, each element rounded
    // once: a thread's 4 x 4 blocks (queries r0 + 0, 2, 4, 6, columns 4c …
    // 4c + 3; Q's 2D blocks, then dO's), all loaded first, go to the
    // operand's rows as they stand and, turned in registers, to the
    // transpose's positions 4pg … 4pg + 3 of rows 4c + e
    constexpr int kBlocks = 2 * T * D / 16, kPer = (kBlocks + kChain - 1) / kChain;
    auto store = [&](const typename S::Raw& raw, typename S::Stage& stage) {
      float4 y[kPer][4];
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int i = hp + n * kChain, b = i % (kBlocks / 2), c4 = b % (D / 4), pg = b / (D / 4);
        const int r0 = (pg >> 1) * 8 + (pg & 1);
        const float* x = i < kBlocks / 2 ? raw.q : raw.dout;
        if (i < kBlocks)
#pragma unroll
          for (int m = 0; m < 4; ++m) y[n][m] = *reinterpret_cast<const float4*>(&x[(r0 + 2 * m) * D + 4 * c4]);
      }
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        const int i = hp + n * kChain, b = i % (kBlocks / 2), c4 = b % (D / 4), pg = b / (D / 4);
        const int r0 = (pg >> 1) * 8 + (pg & 1);
        float* hi = i < kBlocks / 2 ? stage.q : stage.dout;
        float* t_hi = i < kBlocks / 2 ? stage.qt : stage.dot;
        if (i < kBlocks) {
          float4 x[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            x[m] = tf32_4(y[n][m]);
            *reinterpret_cast<float4*>(&hi[cidx<T>(r0 + 2 * m, 4 * c4)]) = x[m];
          }
          float* tt = &t_hi[cidx<D>(4 * c4, 4 * pg)];  // row 4c4 + e lies 4e floats past it (cidx)
          *reinterpret_cast<float4*>(tt) = make_float4(x[0].x, x[1].x, x[2].x, x[3].x);
          *reinterpret_cast<float4*>(tt + 4) = make_float4(x[0].y, x[1].y, x[2].y, x[3].y);
          *reinterpret_cast<float4*>(tt + 8) = make_float4(x[0].z, x[1].z, x[2].z, x[3].z);
          *reinterpret_cast<float4*>(tt + 12) = make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
        }
      }
      if (hp < T)
        stage.lse2[hp] = lse2(raw.stats[0][hp]);
      else if (hp < 2 * T)
        stage.delta[hp - T] = raw.stats[1][hp - T];
    };
    Tile cur;
    if (!seek(0, 0, cur)) return;
    if (p == 0 && kKv > 1) land_kv(0, cur);
    for (int i = 0; i < h; ++i)  // the chain's first tile: tile h
      if (!advance(cur)) return;
    constexpr int kAhead = kRaw / kChains - 1;  // the chain's tiles in flight beyond the one it stores
    Tile ahead = cur;
    bool ahead_ok = true;
    for (int j = 0; j < kAhead; ++j) {  // the chain's first tiles in flight, a commit group each
      if (ahead_ok) {
        land_tile(h + j * kChains, ahead);
        ahead_ok = step(ahead);
      }
      cp_async_commit();
    }
    for (int g = h;; g += kChains) {
      // the chain's tile g has landed (every thread's chunks), and every
      // thread of the chain has read its last tile's raw stage: refill it,
      // kAhead of the chain's tiles ahead (one stage: land tile g there and
      // wait for it)
      if constexpr (kAhead > 0) {
        cp_async_wait<kAhead - 1>();
        named_sync(kProducerBar + h, kChain);
        if (ahead_ok) {
          land_tile(g + kAhead * kChains, ahead);
          ahead_ok = step(ahead);
        }
        cp_async_commit();
      } else {
        named_sync(kProducerBar + h, kChain);
        land_tile(g, cur);
        cp_async_commit();
        cp_async_wait<0>();
        named_sync(kProducerBar + h, kChain);
      }
      if (cur.it == 0 && hp == 0) {  // a block's first tile: the K and V of the block kKv − 1 ahead
        Tile x = cur;
        bool ok = true;
        for (int i = 0; i < kKv - 1 && ok; ++i) ok = seek(x.n + 1, x.b + 1, x);
        if (ok) land_kv(x.b, x);
      }
      const int st = g % kRing;
      if (g >= kRing) bar_wait(&sm.empty[st], (g / kRing - 1) & 1);
      if constexpr (Cut != kNoSplit) store(sm.raw[g % kRaw], sm.st[st]);
      proxy_fence();
      __syncwarp();
      if (hp % 32 == 0) bar_arrive(&sm.ready[st]);
      if (!step(cur)) return;
    }
  }

  // The consumer warpgroups: key rows key0 + 64·wg … of each block.
  regs_inc<P::kConsumerRegs>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float c = scale * kLog2e;  // P = 2^(s·c − lse2)
  const uint32_t k16 = smem_u32(sm.kv_hi[wg][0]) >> 4, v16 = smem_u32(sm.kv_hi[wg][1]) >> 4;
  auto release = [&](uint64_t* bar) {
    if (lane == 0) bar_arrive(bar);
  };
  int gt = 0, nb = 0;
  for (int n = 0, bh, r; walk.next(n, bh, r); ++n) {
    const int key0 = r * kRows, qt0 = first_tile(key0), n_tiles = (s_q - qt0) / T;
    const int wkey0 = key0 + 64 * wg;                            // this warpgroup's first key row
    const int key_a = wkey0 + 16 * warp + g, key_b = key_a + 8;  // the two key rows this thread holds

    float dka[D / 2], dva[D / 2];  // dk / scale and dv
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    if (n_tiles > 0) {
      bar_wait(&sm.kv_full[nb % kKv], (nb / kKv) & 1);
      form_hi<D>(sm.kv[nb % kKv][0] + 64 * wg * D, sm.kv_hi[wg][0], tid);  // its last block's scores are done
      form_hi<D>(sm.kv[nb % kKv][1] + 64 * wg * D, sm.kv_hi[wg][1], tid);
      proxy_fence();
      named_sync(kOwn + wg, 128);
      release(&sm.kv_empty[nb % kKv]);
      ++nb;
      // the tiles this warpgroup computes: causal, from the first whose last
      // query sees its first key (qt + T − 1 >= wkey0 − shift); it frees the
      // ones before unread
      const int skip = wkey0 - shift - T + 1 - qt0, first = Causal && skip > 0 ? min(n_tiles, (skip + T - 1) / T) : 0;
      auto ready = [&](int it) { bar_wait(&sm.ready[(gt + it) % kRing], ((gt + it) / kRing) & 1); };
      for (int it = 0; it < (Cut == kLoadsOnly ? n_tiles : first); ++it) {
        ready(it);
        release(&sm.empty[(gt + it) % kRing]);
      }
      if (Cut != kLoadsOnly) {
        // a tile at a time, as flash_bwd_dkv_tc; causal, its two products one
        // after the other into one partial sum (part)
        for (int it = first; it < n_tiles; ++it) {
          ready(it);
          const typename S::Stage& stage = sm.st[(gt + it) % kRing];
          // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ. s[4j + e] is (key_a, query qt +
          // 8j + 2t + e), s[4j + 2 + e] the same query on key_b; dp likewise.
          float s[T / 2], dp[T / 2];
          if constexpr (Cut == kNoMma) {
#pragma unroll
            for (int i = 0; i < T / 2; ++i) {
              s[i] = 0.03125f * i;
              dp[i] = 0.0625f * (i & 7);
            }
          } else {
            wg_fence();
            ss_split<D, T, false>(s, k16, 0, 0, smem_u32(stage.q) >> 4, 0, 0);
            ss_split<D, T, false>(dp, v16, 0, 0, smem_u32(stage.dout) >> 4, 0, 0);
            wg_commit();
            wg_wait();
            pin(s);
            pin(dp);
          }
          // Pᵀ into s, dSᵀ = Pᵀ ∘ (dPᵀ − delta) into dp
          const int qt = qt0 + it * T;
          const bool mask = Causal && wkey0 + 63 > qt + shift;  // the tile crosses the diagonal
#pragma unroll
          for (int j = 0; j < T / 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(&stage.lse2[8 * j + 2 * t]);
            const float2 dl = *reinterpret_cast<const float2*>(&stage.delta[8 * j + 2 * t]);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float l = e ? l2.y : l2.x, d = e ? dl.y : dl.x;
              float pa = fmaf(s[4 * j + e], c, -l), pb = fmaf(s[4 * j + 2 + e], c, -l);
              if constexpr (Cut != kNoExp) {
                pa = exp2_ftz(pa);
                pb = exp2_ftz(pb);
              }
              if (mask) {
                const int query = qt + 8 * j + 2 * t + e;
                pa = key_a > query + shift ? 0.f : pa;
                pb = key_b > query + shift ? 0.f : pb;
              }
              s[4 * j + e] = pa;
              s[4 * j + 2 + e] = pb;
              dp[4 * j + e] = pa * (dp[4 * j + e] - d);
              dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - d);
            }
          }
          // dv += Pᵀ·dO against dOᵀ and dk += dSᵀ·Q against Qᵀ, Pᵀ and dSᵀ in registers
          uint32_t ph[T / 2], dh[T / 2];
          split_frag<T / 2, false>(s, ph, ph);
          split_frag<T / 2, false>(dp, dh, dh);
          const uint32_t qt16 = smem_u32(stage.qt) >> 4, dot16 = smem_u32(stage.dot) >> 4;
          if constexpr (Cut == kNoMma) {
#pragma unroll
            for (int i = 0; i < D / 2; ++i) {
              dva[i] += __uint_as_float(ph[i % (T / 2)]);
              dka[i] += __uint_as_float(dh[i % (T / 2)]);
            }
          } else if constexpr (Causal) {
            float part[D / 2];
            wg_fence();
            rs_split<D, T, false>(part, ph, ph, dot16, 0, 0, 0);
            wg_commit();
            wg_wait();
            pin(part);
#pragma unroll
            for (int i = 0; i < D / 2; ++i) dva[i] += part[i];
            wg_fence();
            rs_split<D, T, false>(part, dh, dh, qt16, 0, 0, 0);
            wg_commit();
            wg_wait();
            pin(part);
#pragma unroll
            for (int i = 0; i < D / 2; ++i) dka[i] += part[i];
          } else {
            wg_fence();
            rs_split<D, T, false>(dva, ph, ph, dot16, 0, 0);
            rs_split<D, T, false>(dka, dh, dh, qt16, 0, 0);
            wg_commit();
            wg_wait();
            pin(dva);
            pin(dka);
          }
          release(&sm.empty[(gt + it) % kRing]);
        }
      }
      gt += n_tiles;
    }

    float* ka = dk + ((size_t)bh * s_kv + key_a) * D + 2 * t;
    float* kb = dk + ((size_t)bh * s_kv + key_b) * D + 2 * t;
    float* va = dv + ((size_t)bh * s_kv + key_a) * D + 2 * t;
    float* vb = dv + ((size_t)bh * s_kv + key_b) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(ka + 8 * j) = make_float2(dka[4 * j] * scale, dka[4 * j + 1] * scale);
      *reinterpret_cast<float2*>(kb + 8 * j) = make_float2(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
      *reinterpret_cast<float2*>(va + 8 * j) = make_float2(dva[4 * j], dva[4 * j + 1]);
      *reinterpret_cast<float2*>(vb + 8 * j) = make_float2(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// One launch of the one-pass dk/dv: kCtas CTAs an SM, or one a block if
// there are fewer. The cudaError_t of the launch.
template <int D, bool Causal, int Cut = kFull>
int launch(const float* q, const float* k, const float* v, const float* dout, const float* lse, const float* delta,
           float* dk, float* dv, int bh, int s_q, int s_kv, int shift, float scale, cudaStream_t st) {
  constexpr int kCtas = DkvPlan<D>::kCtas;
  const int blocks = bh * (s_kv / DkvPlan<D>::kRows);
  int grid = 0;
  const int e = hopper_tma::persistent_grid((blocks + kCtas - 1) / kCtas, &grid);
  if (e != 0) return e;
  grid = grid * kCtas < blocks ? grid * kCtas : blocks;
  return hopper_tma::launch(flash_bwd_dkv_1p_tc<D, Causal, Cut>, (int)sizeof(DkvSmem<D>) + 1024, dim3(grid),
                            kThreads, st, q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale);
}

// ---------------------------------------------------------------------------
// The one-pass forward at head dim 16 (the note at the top: one pass)
// ---------------------------------------------------------------------------

// The forward's plan by head dim
template <int D>
struct FwdPlan {
  static_assert(D == 16, "D = 32 and 64 keep flash_fwd_tc, D = 128 runs fwd128");
  static constexpr int kRows = 256;                // query rows a block: consumer warpgroups 0 … 3, 64 rows each
  static constexpr int kKeys = Plan<D>::kKeys;     // keys a tile: flash_fwd_tc's (F32_FWD_KEYS in ops/flash_cuda.py)
  static constexpr int kConsumers = 4;             // consumer warpgroups
  static constexpr int kThreads = 128 * kConsumers + kProducers;  // then the producer warpgroup
  static constexpr int kQ = 2;                     // blocks' Q landed: the next block's while this one runs
  static constexpr int kRaw = 4;                   // K/V tiles landed ahead of the one stored
  static constexpr int kRing = 8;                  // operand stages
  static constexpr int kLaunchRegs = kRegisters / kThreads / 8 * 8;  // a thread's registers at launch: 96
  static constexpr int kProducerRegs = 40, kConsumerRegs = 104;     // setmaxnreg
  static_assert(kProducers * kProducerRegs + 128 * kConsumers * kConsumerRegs <= kThreads * kLaunchRegs,
                "setmaxnreg over the CTA's registers");
};

template <int D>
struct FwdSmem {
  using P = FwdPlan<D>;
  static constexpr int T = P::kKeys;
  struct Raw {  // a tile's K and V as landed, row-major; producer warp w lands and reads keys 16w … 16w + 15
    float k[T * D], v[T * D];
  };
  struct Stage {  // its operands: K's hi (`cidx<T>`), Vᵀ's hi (`cidx<D + 8>`, keys permuted; rows D … D + 7 [1 | 0])
    float k[T * D], vt[(D + 8) * T];
  };
  alignas(128) float q[P::kQ][P::kRows * D];  // a block's Q as landed, row-major; warpgroup w's rows at 64·w·D
  alignas(128) Raw raw[P::kRaw];
  alignas(128) Stage st[P::kRing];
  uint64_t q_full[P::kConsumers][P::kQ], q_empty[P::kConsumers][P::kQ], raw_full[4][P::kRaw];
  uint64_t ready[P::kRing], empty[P::kRing];
};
static_assert(sizeof(FwdSmem<16>) == 147840 && smem_fits(1, sizeof(FwdSmem<16>)), "over 227 KB");

// The one-pass forward of q [BH, Sq, D] against k, v [BH, Skv, D] at D =
// 16, as flash_fwd_tc<D, Causal, false> computes it (the note at the top:
// one pass). Persistent: grid min(blocks, SMs), kThreads threads,
// sizeof(FwdSmem<D>) + 1024 bytes of dynamic shared memory. Cut: as
// flash_fwd_tc's (kFull shipped); loads only: the consumers only wait for
// and free each stage (the producer alone); no split: the producer lands
// and stores no K or V (the consumers alone).
template <int D, bool Causal, int Cut>
__global__ void __launch_bounds__(FwdPlan<D>::kThreads, 1)
flash_fwd_1p_tc(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ o, float* __restrict__ lse, int bh_count, int s_q, int s_kv, int shift,
                float scale) {
  using P = FwdPlan<D>;
  using S = FwdSmem<D>;
  constexpr int kRows = P::kRows, kKeys = P::kKeys, kQ = P::kQ, kRaw = P::kRaw, kRing = P::kRing;
  constexpr int kConsumers = P::kConsumers;
  extern __shared__ unsigned char smem_raw[];
  S& sm = aligned_smem<S>(smem_raw);
  const Walk walk{bh_count, (s_q + kRows - 1) / kRows};  // a block: rows row0 … (a head's last may hold 128)

  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w)
      for (int i = 0; i < kQ; ++i) {
        bar_init(&sm.q_full[w][i], 1);   // producer warp w's bar_expect; then the bytes
        bar_init(&sm.q_empty[w][i], 4);  // a warp of consumer warpgroup w each, once it holds its Q
      }
    for (int w = 0; w < 4; ++w)
      for (int i = 0; i < kRaw; ++i) bar_init(&sm.raw_full[w][i], 1);  // producer warp w's bar_expect
    for (int i = 0; i < kRing; ++i) {
      bar_init(&sm.ready[i], 4);                // a producer warp each, after its quarter
      bar_init(&sm.empty[i], 4 * kConsumers);  // a consumer warp each, after the tile's products
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (Cut == kNoSplit) {  // nothing lands: the operands are zeros
    for (unsigned i = threadIdx.x; i < sizeof(sm.st) / 4; i += P::kThreads) reinterpret_cast<float*>(sm.st)[i] = 0.f;
    __syncthreads();
  }
  for (unsigned i = threadIdx.x; i < kRing * 8 * kKeys; i += P::kThreads) {  // Vᵀ's rows D … D + 7 of every stage
    const unsigned r = D + i % (8 * kKeys) / kKeys, at = cidx<D + 8>(r, i % kKeys);
    sm.st[i / (8 * kKeys)].vt[at] = r == D ? 1.f : 0.f;
  }
  proxy_fence();
  __syncthreads();

  // a block's first row, its rows (a head's last block may hold 128) and its K/V tiles (keys [0, kend))
  auto block_row0 = [&](int r) { return (Causal ? walk.blocks - 1 - r : r) * kRows; };
  auto tiles_of = [&](int row0) {
    const int kend = Causal ? min(max(row0 + min(kRows, s_q - row0) + shift, 0), s_kv) : s_kv;
    return (kend + kKeys - 1) / kKeys;
  };

  if (threadIdx.x >= 128 * kConsumers) {
    regs_dec<P::kProducerRegs>();
    // The producer warpgroup, four warps that never wait for each other:
    // warp w lands, by bulk copy, keys 16w … 16w + 15 of each K/V tile kRaw
    // tiles ahead and, a block ahead, the 64 Q rows of consumer warpgroup w;
    // it stores its quarter of each landed tile's operands into the ring as
    // the consumers free the stages: K's hi in operand layout, Vᵀ's hi with
    // the keys of every 8 in the order 0, 2, 4, 6, 1, 3, 5, 7 (positions
    // 4pg … 4pg + 3 for pg = 4w … 4w + 3).
    // Blocks without a tile (causal, wholly in the future) are skipped by
    // both sides.
    const int pw = (threadIdx.x - 128 * kConsumers) / 32, lane = threadIdx.x % 32;
    struct Block {
      int n, bh, row0, n_tiles;  // the n-th block of the walk, its first row and tiles
    };
    auto seek = [&](int n, Block& x) {  // the first block from the n-th on that has a tile
      for (int bh, r; walk.next(n, bh, r); ++n) {
        const int row0 = block_row0(r), nt = tiles_of(row0);
        if (nt > 0) {
          x = Block{n, bh, row0, nt};
          return true;
        }
      }
      return false;
    };
    int nq = 0;  // blocks whose Q this warp landed (lane 0's count)
    auto land_q = [&](const Block& x) {  // lane 0: consumer warpgroup pw's rows of block x, if it has any
      if (x.row0 + 64 * pw >= s_q) return;
      if (nq >= kQ) bar_wait(&sm.q_empty[pw][nq % kQ], ((nq - kQ) / kQ) & 1);
      bar_expect(&sm.q_full[pw][nq % kQ], 64 * D * 4);
      bulk_copy(sm.q[nq % kQ] + 64 * pw * D, q + ((size_t)x.bh * s_q + x.row0 + 64 * pw) * D, 64 * D * 4,
                &sm.q_full[pw][nq % kQ]);
      ++nq;
    };
    Block land;  // lane 0: the next tile to land, `lit` of block `land`
    int lit = 0;
    bool land_ok = true;
    auto land_next = [&](int g) {  // lane 0: that tile's quarter into raw stage g % kRaw; on to the next
      if (!land_ok) return;
      uint64_t* bar = &sm.raw_full[pw][g % kRaw];
      if constexpr (Cut == kNoSplit) {
        bar_arrive(bar);
      } else {
        const size_t row = (size_t)land.bh * s_kv + lit * kKeys + 16 * pw;
        typename S::Raw& raw = sm.raw[g % kRaw];
        bar_expect(bar, 2 * 16 * D * 4);
        bulk_copy(raw.k + 16 * pw * D, k + row * D, 16 * D * 4, bar);
        bulk_copy(raw.v + 16 * pw * D, v + row * D, 16 * D * 4, bar);
      }
      if (++lit == land.n_tiles) {
        lit = 0;
        land_ok = seek(land.n + 1, land);
      }
    };
    // warp pw's quarter of a landed tile into its stage, each element rounded once
    auto store = [&](const typename S::Raw& raw, typename S::Stage& stage) {
#pragma unroll
      for (int m = 0; m < D / 8; ++m) {  // K: key 16pw + i / (D/4), columns 4·(i % (D/4)) … + 3
        const int i = lane + 32 * m, key = 16 * pw + i / (D / 4), c4 = i % (D / 4);
        *reinterpret_cast<float4*>(&stage.k[cidx<kKeys>(key, 4 * c4)]) =
            tf32_4(*reinterpret_cast<const float4*>(&raw.k[key * D + 4 * c4]));
      }
#pragma unroll
      for (int m = 0; m < D / 8; ++m) {  // Vᵀ: positions 4pg … 4pg + 3 of row d hold keys key0 + 0, 2, 4, 6
        const int i = lane + 32 * m, pg = 4 * pw + i / D, d = i % D;
        const int key0 = (pg >> 1) * 8 + (pg & 1);
        const float4 x = make_float4(raw.v[key0 * D + d], raw.v[(key0 + 2) * D + d], raw.v[(key0 + 4) * D + d],
                                     raw.v[(key0 + 6) * D + d]);
        *reinterpret_cast<float4*>(&stage.vt[cidx<D + 8>(d, 4 * pg)]) = tf32_4(x);
      }
    };
    Block cur;
    if (!seek(0, cur)) return;
    if (lane == 0) {
      land = cur;
      land_q(cur);
      for (int j = 0; j < kRaw; ++j) land_next(j);
    }
    for (int g = 0;;) {
      if (lane == 0) {  // a block's first tile: the next block's Q
        Block nx;
        if (seek(cur.n + 1, nx)) land_q(nx);
      }
      for (int it = 0; it < cur.n_tiles; ++it, ++g) {
        bar_wait(&sm.raw_full[pw][g % kRaw], (g / kRaw) & 1);
        if (g >= kRing) bar_wait(&sm.empty[g % kRing], (g / kRing - 1) & 1);
        if constexpr (Cut != kNoSplit) {
          store(sm.raw[g % kRaw], sm.st[g % kRing]);
          proxy_fence();
        }
        __syncwarp();
        if (lane == 0) {
          bar_arrive(&sm.ready[g % kRing]);
          land_next(g + kRaw);  // into the raw stage this warp has read
        }
      }
      if (!seek(cur.n + 1, cur)) return;
    }
  }

  // The consumer warpgroups: rows row0 + 64·wg … + 63 of each block, a tile
  // at a time in flash_fwd_tc's order. A block's first scores are issued
  // before the last block's o and lse are stored, and waited for after.
  regs_inc<P::kConsumerRegs>();
  // the warpgroup and warp, broadcast from lane 0 so that the compiler knows
  // them uniform: the stage addresses and descriptors then stay in uniform
  // registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32 % 4, 0), lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float c = fabsf(scale) * kLog2e;  // p = 2^(s·c − m): m is in units of log2
  const float sgn = scale < 0.f ? -1.f : 1.f;  // folded into Q, so that the kernel scales by |scale|
  constexpr bool kScores = Cut != kLoadsOnly && Cut != kNoMma;  // the scores are products
  auto release = [&](uint64_t* bar) {
    if (lane == 0) bar_arrive(bar);
  };
  struct Block {
    int bh, row0, n_tiles;  // its head, first row and tiles
    int n_vis, n_open;      // the tiles this warpgroup computes (causal: up to its diagonal) and computes unmasked
    bool rows;              // whether this warpgroup has rows in it (none past Sq)
  };
  auto open = [&](int n, Block& x) {  // the walk's n-th block as this warpgroup sees it; false past the last
    int bh, r;
    if (!walk.next(n, bh, r)) return false;
    const int row0 = block_row0(r), n_tiles = tiles_of(row0), wrow0 = row0 + 64 * wg;
    x.bh = bh;
    x.row0 = row0;
    x.n_tiles = n_tiles;
    x.n_vis = Causal ? min(n_tiles, max(wrow0 + shift + 127, 0) / kKeys) : n_tiles;
    x.n_open = Causal ? min(n_tiles, max(wrow0 + shift + 1, 0) / kKeys) : n_tiles;
    x.rows = wrow0 < s_q;
    return true;
  };
  // Q's hi as the A fragments of the scores: k8 step ks holds (row_a, 8ks + t), (row_b, 8ks + t),
  // (row_a, 8ks + t + 4), (row_b, 8ks + t + 4)
  uint32_t qa[D / 8][4];
  // S = Q·Kᵀ of stage st into s, issued and committed, not waited for: s[4j + e] is (row_a, key kt + 8j + 2t +
  // e), s[4j + 2 + e] the same key on row_b. Each tile's s is an array of its own, so that nothing but the
  // wgmmas defines it between their issue and the wait (else ptxas serializes them).
  auto scores = [&](float (&s)[kKeys / 2], int st) {
    const uint32_t k16 = smem_u32(sm.st[st].k) >> 4;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) wgmma_rs_n64(s, qa[ks], desc<kKeys>(k16, 32 * kKeys * ks), ks > 0);
    wg_commit();
  };
  float acc[(D + 8) / 2];  // O and, in column D, the row sum l, of the block whose o and lse are not stored yet
  float m_a, m_b;          // its running max; finite: m − m_new is never inf − inf
  Block last{};            // that block
  bool held = false;       // whether there is one
  auto store = [&]() {     // its o and lse
    if (!held || !last.rows) return;
    const int row_a = last.row0 + 64 * wg + 16 * warp + g, row_b = row_a + 8;
    // l: column D, held by the quad's thread t = 0
    const float l_a = __shfl_sync(0xffffffffu, acc[D / 2], lane & ~3);
    const float l_b = __shfl_sync(0xffffffffu, acc[D / 2 + 2], lane & ~3);
    // masked-row guard: a row that saw no key has l == 0 and acc == 0
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f, inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    float* oa = o + ((size_t)last.bh * s_q + row_a) * D + 2 * t;
    float* ob = o + ((size_t)last.bh * s_q + row_b) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(oa + 8 * j) = make_float2(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      *reinterpret_cast<float2*>(ob + 8 * j) = make_float2(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    }
    if (t == 0) {
      lse[(size_t)last.bh * s_q + row_a] = l_a > 0.f ? fmaf(m_a, kLn2, logf(l_a)) : -1e30f;
      lse[(size_t)last.bh * s_q + row_b] = l_b > 0.f ? fmaf(m_b, kLn2, logf(l_b)) : -1e30f;
    }
  };
  auto reset = [&]() {
#pragma unroll
    for (int i = 0; i < (D + 8) / 2; ++i) acc[i] = 0.f;
    m_a = m_b = -1e30f;
  };

  int gt = 0, nq = 0;  // tiles and blocks' Q this warpgroup has passed
  Block cur;
  for (int n = 0; open(n, cur); ++n) {
    if (!cur.rows || cur.n_tiles == 0) {
      store();
      reset();
      if (!cur.rows)
        for (int it = 0; it < cur.n_tiles; ++it) {  // the stages are freed all the same
          bar_wait(&sm.ready[(gt + it) % kRing], ((gt + it) / kRing) & 1);
          release(&sm.empty[(gt + it) % kRing]);
        }
    } else {
      const int row_a = cur.row0 + 64 * wg + 16 * warp + g, row_b = row_a + 8;  // the two rows this thread holds
      // tile it's softmax (its scores in s) and its P·[V | 1 | 0] into a fresh
      // accumulator, then O = O·corr + P·V (and l = l·corr + Σ P) in FFMAs, as
      // flash_fwd_tc
      auto tile = [&](int it, int st, float (&s)[kKeys / 2]) {
        if constexpr (Cut == kNoMma) {  // scores that differ by element, so that no two exps are one
#pragma unroll
          for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.03125f * i;
        }
        float corr_a, corr_b;
        if (Causal && it >= cur.n_open)  // the tile crosses this warpgroup's diagonal
          softmax_tile<kKeys, true, Cut>(s, it * kKeys, row_a, row_b, shift, t, c, m_a, m_b, corr_a, corr_b);
        else
          softmax_tile<kKeys, false, Cut>(s, it * kKeys, row_a, row_b, shift, t, c, m_a, m_b, corr_a, corr_b);
        // P's TF32 hi: half a unit of its 13 dropped bits added, the bits left
        // for the tensor cores to drop (they read a TF32 operand truncated):
        // tf32(p) without its mask
        uint32_t ph[kKeys / 2];
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) ph[i] = __float_as_uint(s[i]) + 0x1000u;
        pin(ph);
        float pv[(D + 8) / 2];
        if constexpr (Cut == kNoMma) {
#pragma unroll
          for (int i = 0; i < (D + 8) / 2; ++i) pv[i] = __uint_as_float(ph[i % (kKeys / 2)]);
        } else {
          const uint32_t vt16 = smem_u32(sm.st[st].vt) >> 4;
          wg_fence();
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j) {
            const uint32_t a_hi[4] = {ph[4 * j], ph[4 * j + 2], ph[4 * j + 1], ph[4 * j + 3]};
            wgmma_pv<D>(pv, a_hi, desc<D + 8>(vt16, 32 * (D + 8) * j), j > 0);
          }
          wg_commit();
          wg_wait();
          pin(pv);
        }
#pragma unroll
        for (int j = 0; j < (D + 8) / 8; ++j) {
          acc[4 * j] = fmaf(acc[4 * j], corr_a, pv[4 * j]);
          acc[4 * j + 1] = fmaf(acc[4 * j + 1], corr_a, pv[4 * j + 1]);
          acc[4 * j + 2] = fmaf(acc[4 * j + 2], corr_b, pv[4 * j + 2]);
          acc[4 * j + 3] = fmaf(acc[4 * j + 3], corr_b, pv[4 * j + 3]);
        }
      };
      bar_wait(&sm.q_full[wg][nq % kQ], (nq / kQ) & 1);
      const float* qr = sm.q[nq % kQ] + (64 * wg + 16 * warp + g) * D + t;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        qa[ks][0] = tf32(sgn * qr[8 * ks]);
        qa[ks][1] = tf32(sgn * qr[8 * D + 8 * ks]);
        qa[ks][2] = tf32(sgn * qr[8 * ks + 4]);
        qa[ks][3] = tf32(sgn * qr[8 * D + 8 * ks + 4]);
      }
      __syncwarp();
      release(&sm.q_empty[wg][nq % kQ]);
      ++nq;
      // tile 0: its scores issued (whether or not this warpgroup computes
      // the tile), the last block's o and lse stored under them, then waited for
      const int st0 = gt % kRing;
      bar_wait(&sm.ready[st0], (gt / kRing) & 1);
      float s0[kKeys / 2];
      if constexpr (kScores) scores(s0, st0);
      store();
      reset();
      if constexpr (kScores) {
        wg_wait();
        pin(s0);
      }
      if (Cut != kLoadsOnly && cur.n_vis > 0) tile(0, st0, s0);
      release(&sm.empty[st0]);
      for (int it = 1; it < cur.n_tiles; ++it) {
        const int st = (gt + it) % kRing;
        bar_wait(&sm.ready[st], ((gt + it) / kRing) & 1);
        if (Cut != kLoadsOnly && it < cur.n_vis) {
          float s[kKeys / 2];
          if constexpr (kScores) {
            scores(s, st);
            wg_wait();
            pin(s);
          }
          tile(it, st, s);
        }
        release(&sm.empty[st]);
      }
    }
    gt += cur.n_tiles;
    last = cur;
    held = true;
  }
  store();
}

// One launch of the one-pass forward: a CTA an SM, or one a block if
// there are fewer. The cudaError_t of the launch.
template <int D, bool Causal, int Cut = kFull>
int launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q, int s_kv,
               int shift, float scale, cudaStream_t st) {
  int grid = 0;
  const int e = hopper_tma::persistent_grid(bh * ((s_q + FwdPlan<D>::kRows - 1) / FwdPlan<D>::kRows), &grid);
  if (e != 0) return e;
  return hopper_tma::launch(flash_fwd_1p_tc<D, Causal, Cut>, (int)sizeof(FwdSmem<D>) + 1024, dim3(grid),
                            FwdPlan<D>::kThreads, st, q, k, v, o, lse, bh, s_q, s_kv, shift, scale);
}

}  // namespace onepass

// One launch of a backward kernel with its dynamic shared memory; the
// cudaError_t of the launch.
template <typename Kernel, typename... Args>
int launch_bwd(Kernel kernel, int smem, dim3 grid, int threads, cudaStream_t st, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int D, bool Causal, bool Split>
int bwd_dq_d(const float* q, const float* k, const float* v, const float* dout, const float* lse,
             const float* delta, float* dq, int bh, int s_q, int s_kv, int shift, float scale, cudaStream_t st) {
  return launch_bwd(flash_bwd_dq_tc<D, Causal, Split>, (int)sizeof(SmemDq<D>), dim3(s_q / Plan<D>::kRows, bh),
                    Plan<D>::kThreads, st, q, k, v, dout, lse, delta, dq, s_q, s_kv, shift, scale);
}

// dk/dv up to D = 64: split, flash_bwd_dkv_tc; one pass, onepass::flash_bwd_dkv_1p_tc
template <int D, bool Causal, bool Split>
int bwd_dkv_d(const float* q, const float* k, const float* v, const float* dout, const float* lse,
              const float* delta, float* dk, float* dv, int bh, int s_q, int s_kv, int shift, float scale,
              cudaStream_t st) {
  if constexpr (Split)
    return launch_bwd(flash_bwd_dkv_tc<D, Causal>, (int)sizeof(SmemDkv<D>), dim3(s_kv / Plan<D>::kRows, bh),
                      Plan<D>::kThreads, st, q, k, v, dout, lse, delta, dk, dv, s_q, s_kv, shift, scale);
  else
    return onepass::launch<D, Causal>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
}

// the forward up to D = 64: split, flash_fwd_tc; one pass, onepass::flash_fwd_1p_tc at D = 16
template <int D, bool Causal, bool Split>
int fwd_d(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q, int s_kv, int shift,
          float scale, cudaStream_t st) {
  if constexpr (!Split && D == 16)
    return onepass::launch_fwd<D, Causal>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
  else
    return launch_fwd<D, Causal, Split>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
}

int fwd(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q, int s_kv, int d,
        bool causal, int shift, float scale, bool split, void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (instance(d, causal, split)) {
    KERNEL_CASES_64(fwd_d, q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st)
    case 12: return fwd128::launch<false, false>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
    case 13: return fwd128::launch<false, true>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
    case 14: return fwd128::launch<true, false>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
    case 15: return fwd128::launch<true, true>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bwd_dq(const float* q, const float* k, const float* v, const float* dout, const float* lse, const float* delta,
           float* dq, int bh, int s_q, int s_kv, int d, bool causal, int shift, float scale, bool split,
           void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (instance(d, causal, split)) {
    KERNEL_CASES_64(bwd_dq_d, q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st)
    case 12: return dq128::launch<false, false>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);
    case 13: return dq128::launch<false, true>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);
    case 14: return dq128::launch<true, false>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);
    case 15: return dq128::launch<true, true>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int bwd_dkv(const float* q, const float* k, const float* v, const float* dout, const float* lse, const float* delta,
            float* dk, float* dv, int bh, int s_q, int s_kv, int d, bool causal, int shift, float scale, bool split,
            void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (instance(d, causal, split)) {
    KERNEL_CASES_64(bwd_dkv_d, q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st)
    case 12: return bwd128::launch<false, false>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
    case 13: return bwd128::launch<false, true>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
    case 14: return bwd128::launch<true, false>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
    case 15: return bwd128::launch<true, true>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// `passes` (every entry point): 3 for split TF32 (f32 accuracy), 1 for one
// TF32 product a product. Returns the cudaError_t of the launch.

// Forward on `stream`: o [BH, S, D], lse [BH, S]. D in {16, 32, 64, 128},
// S a multiple of 128.
int flash_fwd_launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s,
                     int d, float scale, int passes, void* stream) {
  return tc::fwd(q, k, v, o, lse, bh, s, s, d, true, 0, scale, passes == 3, stream);
}

// dq [BH, S, D] from q, k, v, dO [BH, S, D] and lse, delta [BH, S].
int flash_bwd_dq_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                        const float* delta, float* dq, int bh, int s, int d, float scale, int passes, void* stream) {
  return tc::bwd_dq(q, k, v, dout, lse, delta, dq, bh, s, s, d, true, 0, scale, passes == 3, stream);
}

// dk, dv [BH, S, D] from the same inputs.
int flash_bwd_dkv_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                         const float* delta, float* dk, float* dv, int bh, int s, int d, float scale, int passes,
                         void* stream) {
  return tc::bwd_dkv(q, k, v, dout, lse, delta, dk, dv, bh, s, s, d, true, 0, scale, passes == 3, stream);
}

// Rectangular forward: o [BH, Sq, D], lse [BH, Sq] from q [BH, Sq, D] and
// k, v [BH, Skv, D]; `causal` masks on the global positions q_off + i,
// k_off + j. Sq and Skv multiples of 128, D in {16, 32, 64, 128}.
int flash_fwd_rect_launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q,
                          int s_kv, int d, int causal, int q_off, int k_off, float scale, int passes, void* stream) {
  return tc::fwd(q, k, v, o, lse, bh, s_q, s_kv, d, causal != 0, q_off - k_off, scale, passes == 3, stream);
}

// Rectangular dq [BH, Sq, D] from q, dO [BH, Sq, D], k, v [BH, Skv, D] and lse, delta [BH, Sq].
int flash_bwd_dq_rect_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                             const float* delta, float* dq, int bh, int s_q, int s_kv, int d, int causal,
                             int q_off, int k_off, float scale, int passes, void* stream) {
  return tc::bwd_dq(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, d, causal != 0, q_off - k_off, scale,
                    passes == 3, stream);
}

// Rectangular dk, dv [BH, Skv, D] from the same inputs.
int flash_bwd_dkv_rect_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                              const float* delta, float* dk, float* dv, int bh, int s_q, int s_kv, int d,
                              int causal, int q_off, int k_off, float scale, int passes, void* stream) {
  return tc::bwd_dkv(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, d, causal != 0, q_off - k_off, scale,
                     passes == 3, stream);
}

#ifdef FLASH_F32_CUTS
// The head-dim-128 forward's plans and attribution cuts (chip_sweep.py
// flash_f32), built only with -DFLASH_F32_CUTS and never reached by the
// wrappers: `plan` 0 is the shipped one (two operand stages), 1 one
// stage; `cut` in kFull … kNoSplit at plan 0, kFull at plan 1. Returns
// cudaErrorInvalidValue for a pair the source has no instance of.
int flash_fwd_d128_cut_launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q,
                              int s_kv, int causal, int q_off, int k_off, float scale, int passes, int plan, int cut,
                              void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int shift = q_off - k_off;
  const bool c = causal != 0, sp = passes == 3;
#define FWD128_CASE(R, CUT)                                                                          \
  if (plan == (R == 2 ? 0 : 1) && cut == CUT) {                                                        \
    if (c && sp) return tc::fwd128::launch<true, true, R, CUT>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);   \
    if (c) return tc::fwd128::launch<true, false, R, CUT>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);        \
    if (sp) return tc::fwd128::launch<false, true, R, CUT>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);       \
    return tc::fwd128::launch<false, false, R, CUT>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);              \
  }
  FWD128_CASE(2, tc::kFull)
  FWD128_CASE(2, tc::kNoExp)
  FWD128_CASE(2, tc::kNoMma)
  FWD128_CASE(2, tc::kLoadsOnly)
  FWD128_CASE(2, tc::kNoSplit)
  FWD128_CASE(1, tc::kFull)
#undef FWD128_CASE
  return (int)cudaErrorInvalidValue;
}

// The head-dim-128 dk/dv's plans and cuts, as above: `plan` 0 is the
// shipped one (two score stages), 1 one score stage.
int flash_bwd_dkv_d128_cut_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                                  const float* delta, float* dk, float* dv, int bh, int s_q, int s_kv, int causal,
                                  int q_off, int k_off, float scale, int passes, int plan, int cut, void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int shift = q_off - k_off;
  const bool c = causal != 0, sp = passes == 3;
#define DKV128_CASE(R, CUT)                                                                                   \
  if (plan == (R == 2 ? 0 : 1) && cut == CUT) {                                                                 \
    if (c && sp)                                                                                                \
      return tc::bwd128::launch<true, true, R, CUT>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift,    \
                                                    scale, st);                                                 \
    if (c)                                                                                                      \
      return tc::bwd128::launch<true, false, R, CUT>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift,   \
                                                     scale, st);                                                \
    if (sp)                                                                                                     \
      return tc::bwd128::launch<false, true, R, CUT>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift,   \
                                                     scale, st);                                                \
    return tc::bwd128::launch<false, false, R, CUT>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift,    \
                                                    scale, st);                                                 \
  }
  DKV128_CASE(2, tc::kFull)
  DKV128_CASE(2, tc::kNoExp)
  DKV128_CASE(2, tc::kNoMma)
  DKV128_CASE(2, tc::kLoadsOnly)
  DKV128_CASE(2, tc::kNoSplit)
  DKV128_CASE(1, tc::kFull)
#undef DKV128_CASE
  return (int)cudaErrorInvalidValue;
}

// The head-dim-128 dq's plans and cuts, as above: `plan` 0 is the shipped
// one (two transposes stages), 1 three transposes stages.
int flash_bwd_dq_d128_cut_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                                 const float* delta, float* dq, int bh, int s_q, int s_kv, int causal, int q_off,
                                 int k_off, float scale, int passes, int plan, int cut, void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int shift = q_off - k_off;
  const bool c = causal != 0, sp = passes == 3;
#define DQ128_CASE(R, CUT)                                                                                         \
  if (plan == (R == 2 ? 0 : 1) && cut == CUT) {                                                                    \
    if (c && sp)                                                                                                   \
      return tc::dq128::launch<true, true, R, CUT>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);  \
    if (c)                                                                                                         \
      return tc::dq128::launch<true, false, R, CUT>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st); \
    if (sp)                                                                                                        \
      return tc::dq128::launch<false, true, R, CUT>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st); \
    return tc::dq128::launch<false, false, R, CUT>(q, k, v, dout, lse, delta, dq, bh, s_q, s_kv, shift, scale, st);  \
  }
  DQ128_CASE(2, tc::kFull)
  DQ128_CASE(2, tc::kNoExp)
  DQ128_CASE(2, tc::kNoMma)
  DQ128_CASE(2, tc::kLoadsOnly)
  DQ128_CASE(2, tc::kNoSplit)
  DQ128_CASE(3, tc::kFull)
#undef DQ128_CASE
  return (int)cudaErrorInvalidValue;
}

// flash_fwd_tc's attribution cuts at every instance the entry points run
// (chip_sweep.py flash_1p; `tc::launch_fwd_cut`), split when `passes` is
// 3; `cut` in kFull … kNoSplit.
int flash_fwd_tc_cut_launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q,
                            int s_kv, int d, int causal, int q_off, int k_off, float scale, int passes, int cut,
                            void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int shift = q_off - k_off;
  const bool c = causal != 0, sp = passes == 3;
#define FWDTC_CASE(D, CUT)                                                                                    \
  if (d == D && cut == CUT)                                                                                   \
    return c ? tc::launch_fwd_cut<D, true, CUT>(sp, q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st)         \
             : tc::launch_fwd_cut<D, false, CUT>(sp, q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
#define FWDTC_CASES(CUT) FWDTC_CASE(16, CUT) FWDTC_CASE(32, CUT) FWDTC_CASE(64, CUT)
  FWDTC_CASES(tc::kFull)
  FWDTC_CASES(tc::kNoExp)
  FWDTC_CASES(tc::kNoMma)
  FWDTC_CASES(tc::kLoadsOnly)
  FWDTC_CASES(tc::kNoSplit)
#undef FWDTC_CASES
#undef FWDTC_CASE
  return (int)cudaErrorInvalidValue;
}

// The one-pass forward's attribution cuts at D = 16 (chip_sweep.py
// flash_1p), as above: `cut` in kFull … kNoSplit.
int flash_fwd_1p_cut_launch(const float* q, const float* k, const float* v, float* o, float* lse, int bh, int s_q,
                            int s_kv, int d, int causal, int q_off, int k_off, float scale, int cut, void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv) || d != 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int shift = q_off - k_off;
#define FWD1P_CASE(CUT)                                                                                          \
  if (cut == CUT)                                                                                                \
    return causal ? tc::onepass::launch_fwd<16, true, CUT>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st)    \
                  : tc::onepass::launch_fwd<16, false, CUT>(q, k, v, o, lse, bh, s_q, s_kv, shift, scale, st);
  FWD1P_CASE(tc::kFull)
  FWD1P_CASE(tc::kNoExp)
  FWD1P_CASE(tc::kNoMma)
  FWD1P_CASE(tc::kLoadsOnly)
  FWD1P_CASE(tc::kNoSplit)
#undef FWD1P_CASE
  return (int)cudaErrorInvalidValue;
}

// The one-pass dk/dv's attribution cuts at D = 16 (chip_sweep.py
// flash_1p), as above: `cut` in kFull … kNoSplit.
int flash_bwd_dkv_1p_cut_launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                                const float* delta, float* dk, float* dv, int bh, int s_q, int s_kv, int d,
                                int causal, int q_off, int k_off, float scale, int cut, void* stream) {
  if (!rect_shape_ok(bh, s_q, s_kv) || d != 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int shift = q_off - k_off;
#define DKV1P_CASE(CUT)                                                                                             \
  if (cut == CUT)                                                                                                   \
    return causal ? tc::onepass::launch<16, true, CUT>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift,    \
                                                       scale, st)                                                   \
                  : tc::onepass::launch<16, false, CUT>(q, k, v, dout, lse, delta, dk, dv, bh, s_q, s_kv, shift,   \
                                                        scale, st);
  DKV1P_CASE(tc::kFull)
  DKV1P_CASE(tc::kNoExp)
  DKV1P_CASE(tc::kNoMma)
  DKV1P_CASE(tc::kLoadsOnly)
  DKV1P_CASE(tc::kNoSplit)
#undef DKV1P_CASE
  return (int)cudaErrorInvalidValue;
}
#endif

}  // extern "C"
