#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (simplellminference_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:

  1. device   — the card's name, device count, nvidia-smi name and power
                limit. No CUDA device: exit 1 before any result.
  2. build    — compile csrc/*.cu (nvcc, sm_90a) and print the build time
                and the ptxas register / shared-memory lines, and the
                HGMMA (tensor-core) instruction count of each tensor-core
                kernel's instantiations in `cuobjdump -sass`, counted
                while the later phases run and printed after them (a line
                says so where cuobjdump is missing; never a failure).
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                card, at the main paths' shapes (Llama-2-7B: H=4096,
                I=11008, N=kvN=32, D=128, V=32000, page 128, batch 8,
                128-token prompts, kv_len 128-160, bf16), a GQA shape
                (TinyLlama: H=2048, I=5632, N=32, kvN=4, D=64), ragged
                prompts and K % 128 != 0, fused_ffn at m 1, 8, 9, 40
                and 64 (bf16: the tensor cores, mma.sync; f32 at 7B
                width timed too: the FMA kernels), and
                paged_flash_prefill at the
                `prefix` path's dispatches (8 x 64 suffix rows and one
                256-row chunk at offset 512, kv_len 540-576, bf16) and a
                GQA case with ragged offsets, an unmapped page and a
                padding row (f32); then INT8 KV: paged_append_decode_quant
                and paged_append_prefill_quant byte-equal to their plain
                versions (bf16 and f32 rows), the INT8-KV forms of
                paged_flash_decode and paged_flash_prefill at the same
                shapes as their bf16 forms (int8 pools, f32 scale pools),
                and the quantizing fused_qkv_append (codes at most 1
                apart, scales within one bf16 ulp of the absmax or 1e-5
                relative in f32); then speculative decoding:
                paged_append_span byte-equal (8 x 5 rows at 7B, 8 rows at
                GQA f32, a span across a page, a dead row) and
                paged_flash_verify and its INT8-KV form at S in {1, 2, 5,
                8}, GQA (N=32, kvN=8) and not, f32 and bf16, timed at the
                spec paths' 8 x 5-row call; then the INT4 product (and
                its zero-point form, AWQ) at every 7B product's shape,
                M in {1, 8, 1024}, per-channel and group 128, ragged M and
                K/2 off a multiple of 128, each case with its regime
                (tensor cores: mma.sync at M <= 8, wgmma above, with bf16
                activations; FMA kernels otherwise), its decode cases
                also timed over weight copies past the 50 MB L2, and the
                W8A8 product at the
                four prefill products, M in {128, 1024} and ragged, each
                with its regime (the int8 tensor cores, wgmma, or dp4a
                for K or N off 16 and groups off 128: timed at the
                group-64 wqkv), the count of its per-channel outputs
                bit-unequal to the plain version and the quantize ops'
                share of its time, with
                both quantizers byte-equal card vs CPU; then the sliding-
                window forms (3w, 4w/4qw/4vw/4vqw, 8w/8qw at the
                `mistral_window` path's shapes and at windows 200 and 6,
                over ring tables whose columns below the window band
                point at NaN pages, which no form may read) and 6k
                (kv_layer != layer); then kernels 16 (fused_wo_ffn at
                Llama-2-7B and Mistral-7B widths, m = 8, and an
                oversubscribed cooperative grid refused) and 17
                (flash_decode_dyn at the `dense` arena, bk 128 and 256
                equal), which no path runs. Every bf16 case of the fused
                qkv (6, 6d, 6q, 6k: 7B at 1, 8 and 64 rows, an unmapped
                row, TinyLlama's GQA, Mistral's kv_layer, the dense
                arena's edges) runs its tensor-core regime (6m) and is
                timed beside the FMA kernel it replaces (forced, the same
                inputs), the main cases also over weight copies past the
                L2; so is kernel 5's few-rows regime (5r: the decode wo
                and head at 1 and 8 rows, an odd 64-column group), with
                its K-split cap swept at the wo. Every form of the decode
                attention kernel (4*, 13) is held to one bf16 ulp of each
                output (+ 1e-5 of the largest), with split-edge cases
                (kv_len 0, 1, each boundary of the key splits +- 1, a dead
                slot) and timed at the long step's shape too (B 8, kv_len
                4096); kernel 5 is timed at `mistral_window`'s 256-row
                chunk and at M 16, 64 and 65, its tensor-core regime
                (quantized_matmul_mma) apart. The bf16 forms of kernels
                3 and 8 (3, 3w, 8, 8q, 8w, 8qw: tensor cores) are held
                to the same one-ulp rule, their f32 forms to TOL. Then
                FP8 (e4m3) KV: the card's conversion byte-equal to the
                plain to_e4m3 over all 65,536 bf16 bit patterns (form 2e)
                and the f32 edges (1e); the writes 1e, 2e and 11e
                byte-equal to their plain versions (rows past 464: NaN
                codes); 4e, 4ve and 8e at their e4m3-less forms' cases by
                the same rules; 6e's k/v codes at most one e4m3 step
                apart. Then head_dim 256 at Gemma-2B's shapes (8 q heads
                over one kv head, page 128, batch 8): 1 and 2 byte-exact,
                3, 4, 13 and 8 by the same rules as their other head dims
                (split walks, split edges, kv_len 4096, f32 forms), 6m and
                the FMA kernel 6 (f32 rows, and forced beside 6m on bf16
                rows) and 6d; each D-256 form has its own row, and
                sinks at D 256 must raise before any launch. Then
                Gemma-2-2B's
                shapes (8 q heads over 4 kv heads, D 256, soft cap 50,
                window 4096): the capped forms 3c, 3wc, 4c, 4wc (over ring
                tables, NaN pages below the band), 8c and 8wc by their
                uncapped forms' rules, past the cap (|s| several times
                it), at window edges and kv_len 0, in f32 and at D 128,
                each timed case beside scaled_dot_product_attention
                without the cap; and 6k at D 256 (timed beside the FMA
                kernel forced). Then Gemma-2 on the dense arena and under
                speculation: 13c/256 and 13wc/256 at `gemma2_dense`'s
                decode (4 rows over an arena of 8192 slots, kv_len
                4224-4288) and the draft's rollout, 13w at Mistral-7B's
                decode (window 4096), kv_len 0, below the window, its
                edges and past it, past the cap, f32 and D 128; the
                verify forms at S 5: 4v/256 and 4vw/256 at Gemma-1's
                group of 8 (two row blocks), 4vc/256 and 4vwc/256 at
                Gemma-2-2B's and -9B's groups of 2 (the window over ring
                tables, NaN pages below the band), D 128, f32. Then
                gpt-oss-20b's attention (64 q heads over 8 kv heads of 64,
                window 128, sinks drawn N(0, 1)): the sink forms 3s, 3ws,
                4s, 4ws (over ring tables, NaN pages below the band), 8s
                and 8ws at its paths' shapes by their sinkless forms'
                rules, with a case of each where the sink lies above every
                score (4s at kv_len 4096 and 8s at offset 4096 split their
                key walks: a sink seeded in every split would be counted
                several times), kv_len 0 rows and f32, each timed case
                beside scaled_dot_product_attention without sinks; and
                the sink forms on verify rows and on the dense arena: 4vs
                and 4vws at S 5 (40 rows a kv head: two row blocks) at
                `gpt_oss_spec`'s verify step (the window over ring
                tables, NaN pages below the band), 13s and 13ws at
                `gpt_oss_dense`'s decode (an arena of 256 slots), each
                with a split walk and a sink above every score, edges and
                f32. Then INT8 KV with those options and at D 256
                (check_int8kv_options): the sink forms over int8 pools
                (4qs, 4qws, 4vqs, 4vqws, 8qs, 8qws) at gpt-oss-20b's
                shapes, a sink above every score where walks split; the
                capped ones at D 256 (4qc, 4qwc, 4vqc, 4vqwc, 8qc, 8qwc)
                at Gemma-2-2B's and -9B's, scores past the cap, and at D
                128; the uncapped ones at D 256 (4q, 4qw, 4vq at Gemma-1's
                group of 8 x 5 rows, 4vqw, 8q, 8qw); ring tables whose
                columns below the band sit on pages with NaN scales,
                kv_len 0, f32; the writes 9 and 10 at D 256 byte-equal;
                6q at D 256 (a head's columns in two blocks, a further
                launch quantizing whole heads) with and without a
                kv_layer, codes at most one apart, its graph replay bit
                for bit. Then FP8 KV with sinks and windows
                (check_fp8kv_options): the sink forms over e4m3 pools
                (4es, 4ews, 4ves, 4vews, 8es, 8ews) at gpt-oss-20b's
                shapes, a sink above every score where walks split; the
                window forms 4ew, 4vew, 8ew at Mistral-7B's, over ring
                tables whose columns below the band sit on pages of NaN
                codes, kv_len 0, f32; 6ek (the fused qkv into e4m3 ring
                pools at a kv_layer) in check_fused_qkv_fp8kv, codes at
                most one step apart; and Gemma over FP8 KV in the same
                check: the capped e4m3 forms at D 256 (4ec, 4ewc, 4vec,
                4vewc, 8ec, 8ewc) at Gemma-2-2B's and -9B's shapes, scores
                past the cap, and at D 128; the e4m3 forms at Gemma-1's
                D 256 (4e, 4ew, 4ve at its group of 8 x 5 rows, 4vew, 8e,
                8ew); windows over ring tables with NaN-code pages below
                the band, kv_len 0, f32; then 1e, 2e, 11e at D 256 byte-
                equal and 6e/256 (Gemma-2B) and 6ek/256 (Gemma-2-2B's ring
                pools) in check_fp8kv_d256_writes; then FP8 KV on the
                dense arena (check_dense_fp8kv): 12e (kv_append into an
                e4m3 arena) byte-equal at Llama-2-7B's, Gemma-2-2B's (D
                256) and gpt-oss-20b's calls, rows past 464 and slots
                past Smax included; 13e, 13ew, 13ec/256, 13ewc/256, 13es,
                13ews and 13e/256 by the rounding rule at the three
                dense paths' decode shapes and Mistral-7B's window, over
                arenas whose slots past kv_len and below the band hold
                NaN codes (0x7f), no output moved by them; 6de and
                6de/256 (6m; f32 rows on the FMA kernel) codes at most one
                e4m3 step from the plain version's; then absorbed MLA's
                shared-KV forms (check_mla) at DeepSeek-V2-Lite's absorbed
                geometry (16 q heads over one 640-lane latent row): 1l
                and 2l byte-equal with the V pool absent and the other
                pages untouched, 4l/640 (the `mla` path's decode, kv_len
                4096, f32, edges), 8l/640 (chunks at offsets 0 and 512,
                f32), 3l/640 (8 x 128 rows, f32, ragged), 4l and 8l at
                D 128. Max |error| beside
                its tolerance, kernel / plain / library times from
                CUDA-graph replay, and the bound (the least time for the
                bytes and operations of the call on an H100 SXM:
                3.35 TB/s, 989 TFLOP/s bf16, 67 TFLOP/s f32, 1,979 TOP/s
                int8).
  4. engine   — the Engine serving Llama-2-7B at full width and depth
                (32 layers, random weights from a seeded generator on the
                card), 8 requests of 128-token prompts, 32 new tokens,
                burst 16, page 128, twice: with INT8 weights as bench.py
                draws them (its default path) and with bf16 weights
                (bench.py --fp). All requests must finish; each kernel's
                launch count, reset to 0 before the measured run of a path
                and read after it, must match what that path implies; no
                plain version may run on the card. Decode tokens/s from the
                median walls of interleaved 32- and 16-token runs, after a
                32-token warm-up, and one graph-replayed decode step beside
                its bytes floor (the INT8 path's also split by kernel,
                torch.profiler); every path's regime counts of kernels 5,
                6, 7 and 15 held too (no few-row FMA product, no FMA qkv on
                a bf16 path). Then the `prefix` path, the server's
                default configuration (prefix cache on, 16 entries) with
                prefill_chunk 256 and INT8 weights: a 512-token system
                prompt + 64-token suffixes, one request (3 chunks), 7
                sharing its pages after its first step (one suffix batch),
                8 hitting the persistent store after all finish (one
                suffix batch); exact launch counts and prefix metrics, and
                the last wave's admit beside the same prompts uncached.
                Then INT8 KV: `int8kv` (bench.py --kv-dtype int8: INT8
                weights and KV, as the int8 path) with two graph-replayed
                decode steps at kv_len 4096, batch 8, over bf16 and INT8
                pools filled from a seed, beside their bytes floors; and
                `int8kv_prefix` (the server CLI's --kv-dtype int8: bf16
                weights, the prefix cache on; the prefix path's traffic).
                Then speculation: `spec` (the server CLI's --spec-tokens 4:
                bf16 weights and KV, the prefix cache on, burst 4) and
                `spec_int8kv` (bench.py --kv-dtype int8 with spec_tokens
                4): 8 greedy requests of 128-token prompts, half of them a
                repeated 16-token pattern, 64 new tokens; exact launch
                counts (no single-row decode kernel runs), the acceptance
                rate, decode tok/s with and without speculation, and (bf16
                KV) a graph-replayed verify step (S = 5) beside a decode
                step at context 152. Then the dense Generator (`dense`,
                `dense_bf16`) and draft-model speculation (`draft`); then
                INT4 weights as bench.py --quant int4 draws them through
                the Engine (`int4`, rate and step as the int8 path) and
                the Generator (`int4_dense`), every product on the INT4
                kernel (each also counted in its tensor-core regime) and
                the Engine's admission (max TTFT of its wave of 8
                prompts) printed; and `w8a8` (the server CLI's
                --act-quant: the
                prefix path's traffic, every prefill product of 128 rows
                or more on the W8A8 kernel), each wave's TTFT beside the
                `prefix` path's. Then `mistral_window`: Mistral-7B (4
                layers, sliding_window 4096, bench.py's INT8 weights,
                bf16 KV, prefill_chunk 256) in the grouped engine, 4
                greedy prompts of 4224 tokens and 320 new ones (the ring
                of 35 pages wraps: kv_len 4544 > 4480), then bench.py's
                shape for the decode rate beside `int8`'s. FP8 KV runs
                after the INT8-KV paths: `fp8kv` (bench.py --kv-dtype
                fp8: INT8 weights, e4m3 pools; the int8kv path also times
                a decode step at kv_len 4096 over e4m3 pools beside its
                floor), `fp8kv_prefix` (the server CLI's --kv-dtype fp8:
                bf16 weights, the prefix path's traffic) and `spec_fp8kv`
                (spec_tokens 4 over e4m3 pools, INT8 weights), each with
                its exact launch counts. Depth cuts, to keep the run
                within half its time limit: the spec paths, `bf16`,
                `dense_bf16`, `int4`, `int4_dense`, `mistral_window`,
                `gemma2`, `gemma2_window`, `gemma2_dense`, `gemma2_spec`,
                `gemma2_draft`'s target, `draft`'s target, both
                drafters (TinyLlama, Gemma-2-2B), `gpt_oss_prefix`,
                `gpt_oss_spec`, `gpt_oss_dense` and the INT8-KV paths of
                gpt-oss-20b and the Gemmas, `gpt_oss`, `gemma_prefix`,
                `dense`, `prefix`, `w8a8`, `int8kv`, `int8kv_prefix`,
                `fp8kv`, `fp8kv_prefix` and `gemma` at 4 layers (every
                path but `int8`). Then,
                Gemma-2B at full width (4 of its 18 layers, H 2048,
                I 16384, V 256000, 8 heads over one kv head of 256,
                GeGLU, the embedding scale, a tied bf16 head): `gemma`
                (bench.py's shape with INT8 weights, the prefix cache
                off: 2, 3, 6m, 4, 5r and 5m, each D-256 form's row too)
                and `gemma_prefix` (the server's default: bf16 weights,
                the prefix path's traffic: 2, 8, 1 and 4), each with its
                exact launch counts, decode rate, graph-replayed step,
                bytes floor, idle share and TTFT. Then Gemma-2-2B at full
                width (4 of its 26 layers, H 2304, I 9216, V 256000, 8
                heads over 4 kv heads of 256, soft caps 50 and 30, the
                sandwich norms, sliding and full layers alternating at
                window 4096, a tied head) in the grouped engine: `gemma2`
                (bench.py's shape with INT8 weights: 3c, 3wc, 6k, 4c, 4wc,
                5r, 5m) and `gemma2_window` (4 layers, bf16 weights,
                prefill_chunk 256, 4 x 4224-token prompts + 320 new ones:
                8c, 8wc, 2, 1, 4c, 4wc; the window trims and the ring
                of 35 pages wraps), each with its exact launch counts,
                graph-replayed step beside its bytes floor, and idle
                share. Then Gemma-2
                on the dense arena and under speculation, at 4 layers:
                `gemma2_dense` (bench.py's Generator.generate_fused, INT8
                weights, 4 x 4224-token prompts, max_seq 4608, 64 new
                tokens: 12, 3c, 3wc, 6d (6m), 13c, 13wc, 5r, 5m; the
                sliding layers' window trims from the first step),
                `gemma2_spec` (the server CLI's --spec-tokens 4 at
                Gemma-2-2B, bf16, the grouped engine, the `spec` traffic:
                2, 3c, 3wc, 11, 4vc, 4vwc) and `gemma2_draft` (Gemma-2-9B
                at its published width and 4 of its 42 layers,
                google/gemma-2-9b's config.json in `GEMMA2_9B_HF`, bf16,
                drafted by Gemma-2-2B at 4 layers, the `draft` traffic:
                the rollout's 12, 13c, 13wc, 3c, 3wc, the target's 4vc,
                4vwc), each with its exact launch counts. Last,
                gpt-oss-20b at full width (openai/gpt-oss-20b's
                config.json in `GPT_OSS_20B_HF`: 24 layers, H 2880, 64
                heads over 8 kv heads of 64, sinks, q/k/v/o biases, yarn
                rotary, 32 experts of 2880 with top 4 and their biases,
                V 201088, window 128 on the even layers) in the grouped
                engine: `gpt_oss` (4 layers; bench.py's shape, the
                layer products and folded experts quantized to INT8 by
                the port's quantize_params, an INT8 head: 3s, 3ws, 2, 1,
                4s, 4ws, 5r, 5m) and `gpt_oss_prefix` (4 layers; the
                server's default: bf16 weights, the prefix path's
                traffic, which the grouped engine prefills as 3 chunks a
                prompt: 8s, 8ws, 2, 1, 4s, 4ws), each with its exact
                launch counts, decode rate, graph-replayed step beside
                its bytes floor (every folded
                expert read), idle share and TTFT; then, at 4 layers,
                `gpt_oss_spec` (the server CLI's --spec-tokens 4: bf16,
                the `spec` traffic: 3s, 3ws, 2, 11, 4vs, 4vws; the MoE on
                verify rows padded with no host read) with the
                acceptance, tok/s with and without speculation, the
                graph-replayed verify and decode steps beside their
                engine steps, the bytes floor and the idle share, and
                `gpt_oss_dense` (bench.py's Generator.generate_fused,
                INT8 weights as `gpt_oss`, 8 x 128-token prompts,
                max_seq 1024, decoding past the window: 12, 3s, 3ws, 13s,
                13ws, 5r, 5m; its decode steps under sync debug mode
                "error"), each with its exact launch counts. Then INT8
                KV for gpt-oss-20b and the Gemmas, at 4 layers:
                `gpt_oss_int8kv` (bench.py
                --kv-dtype int8 at `gpt_oss`'s shape: 4qs, 4qws, 9, 10),
                `gpt_oss_spec_int8kv` (the server CLI's --kv-dtype int8
                --spec-tokens 4, bf16, the prefix path's traffic in 256-row
                chunks: 8qs, 8qws, 4vqs, 4vqws), `gemma_int8kv_prefix`
                (Gemma-2B, INT8 weights and KV, the prefix traffic: 6q,
                8q, 4q, 10 at D 256), `gemma2_int8kv` (bench.py --kv-dtype
                int8 at Gemma-2-2B, the grouped engine: 6q with a
                kv_layer, 4qc, 4qwc, 10 at D 256) and
                `gemma2_spec_int8kv` (--kv-dtype int8 --spec-tokens 4 at
                Gemma-2-2B, bf16, the prefix traffic: 8qc, 8qwc, 4vqc,
                4vqwc at D 256), each with its exact launch counts, its
                device step beside the bytes floor and the idle share,
                the spec paths' greedy outputs beside spec_tokens=0's
                (printed). And FP8 KV for gpt-oss-20b: `gpt_oss_fp8kv`
                (bench.py --kv-dtype fp8 at `gpt_oss`'s shape: 1e, 2e, 3s,
                3ws, 4es, 4ews) and `gpt_oss_spec_fp8kv` (the server
                CLI's --kv-dtype fp8 --spec-tokens 4, bf16, the prefix
                traffic: 2e, 8es, 8ews, 4ves, 4vews, 11e). Last, FP8 KV
                for the Gemmas, each path after its INT8-KV twin and
                printing its step beside the twin's:
                `gemma_fp8kv_prefix` (Gemma-2B, INT8 weights, the prefix
                traffic: 6e, 8e, 4e, 2e at D 256), `gemma2_fp8kv`
                (bench.py --kv-dtype fp8 at Gemma-2-2B, the grouped
                engine: 6ek, 4ec, 4ewc, 2e at D 256) and
                `gemma2_spec_fp8kv` (--kv-dtype fp8 --spec-tokens 4, bf16,
                the prefix traffic: 8ec, 8ewc, 4vec, 4vewc, 11e, 2e at D
                256). FP8 KV on the dense arena, each path right after
                its bf16-KV twin (sharing its draw) and printing its
                decode step beside the twin's and its bytes floor, at 4
                layers: `dense_fp8kv` (bench.py's Generator with
                --kv-dtype fp8 at Llama-2-7B, INT8 weights: 12e, 6de,
                13e), `gemma2_dense_fp8kv` (Gemma-2-2B, 4 x 4224-token
                prompts: 12e/256, 6de/256, 13ec/256, 13ewc/256) and
                `gpt_oss_dense_fp8kv` (gpt-oss-20b: 12e at every step,
                13es, 13ews), each with its exact launch counts and its
                decode steps under sync debug mode "error". Last,
                absorbed MLA as benchmarks/bench_mla.py's run() serves
                it (DeepSeek-V2-Lite's attention geometry, dense FFNs, 4
                layers, bf16, the Engine's defaults with chunk 512, 8 x
                1024-token prompts, 128 new tokens): `mla` (one shared
                latent pool, cache.v None: 8l, 2l, 4l, 1l at D 640, no
                two-pool form) and its naive twin `mla_naive` (8/256, 2,
                4/256, 1), one draw, each with its KV bytes per token, its
                decode step beside the twin's and the ratio of the two.
                Consecutive paths of one model, depth and weights
                share one draw.
  5. cpu      — the same port at Llama-2-7B width, 1 layer, f32, TF32 off,
                on the card (kernels) and on the host CPU (plain
                versions), from one draw of the weights (on the card,
                copied to the host), 4 requests,
                with bf16-path float weights and with INT8 weights
                quantized by the port: prefill and per-step logits of
                forward_paged within 1e-3, and the Engine's greedy tokens
                equal on both devices except where the top-2 margin is
                below that tolerance; and the `prefix` path's traffic at a
                small size with the float weights, its greedy tokens equal
                on both devices and to the cache-off trace by the same
                rule. Each of these again over INT8 KV pools (the prefix
                traffic with the float weights), and the INT8 weights
                over FP8 (e4m3) KV (layer 0's codes at most one step
                apart, logits within 1e-2 once codes part). And the spec
                Engine
                (spec_tokens 4) on both devices, float weights over f32 KV
                and INT8 weights over INT8 KV: greedy tokens equal card vs
                CPU, to the same Engine with spec_tokens=0 and to the
                CPU's greedy trace, by the same rule, and equal
                speculative metrics. Then the Generator, the self-drafted
                Engine and quantize_params; INT4 (quantize_params, group
                128) through the Engine and the Generator, AWQ (params
                from a seeded in-memory fetcher) through the Engine, and
                again with bf16 activations on the card's tensor-core
                regimes (greedy outputs card == CPU printed); and
                W8A8 over group-128 INT8 weights, the Engine also on
                prefix traffic, the card carrying on with the CPU's
                activation codes (its own within one step of them).
                Last, sliding windows at Mistral-7B width (1 layer: every
                layer slides, so one runs every form; window 4096, f32):
                one 4448-token prompt through the
                grouped pools in 256-row chunks and 40 new tokens (the
                ring wraps), logits of every step within 1e-3, greedy
                tokens equal, and the card's grouped Engine to the CPU's
                tokens. Then Gemma-2B at full width, 1 layer, f32 and
                INT8 weights (the tied head the f32 embedding), 8 greedy
                steps and the prefix traffic, by the same rules; and
                Gemma-2-2B at full width, 2 layers (a sliding and a full
                one), f32 and INT8 weights, the sandwich norms drawn away
                from ones, by the same rules; and, the window cut to 32 so
                that the prompts and steps pass it, the Generator, the
                prompt-lookup spec Engine and the draft Engine (a
                Gemma-2-9B-wide target of 2 layers drafted by that
                Gemma-2-2B) on both devices. Then gpt-oss-20b at full
                width, 2 layers (a sliding and a full one), f32, the
                window cut to 32: 8 greedy steps and the prefix traffic
                (chunked over the ring pools), the Generator and the
                prompt-lookup spec Engine by the same rules; the card
                runs every sink form. gpt-oss-20b and Gemma-2-2B also over
                INT8 KV (prefill + 8 steps and the Engine, the INT8-KV
                rule: 4qs, 4qws, 4qc/256, 4qwc/256 on the card), and
                gpt-oss-20b over FP8 KV (the FP8-KV rule: 4es, 4ews),
                and Gemma-2-2B over FP8 KV (the FP8-KV rule: 2e, 1e,
                4ec, 4ewc at D 256, counted as `gemma2_fp8kv_cpu`), and
                its Generator over an e4m3 arena (the window cut to 32;
                the card carrying on with the CPU's codes, by the FP8-KV
                rule: 12e/256, 13ec/256, 13ewc/256, counted as
                `gemma2_dense_fp8kv_cpu`); and bench_mla.py's widths at 1
                layer, absorbed and naive, card vs CPU (3l/640, 4l/640,
                1l, 2l, and 8l/640 on the prefix traffic), absorbed ==
                naive on the card, counted as `mla_cpu`.

Then one line ``{"kernels": [...]}`` (each kernel's launches on every
path, and in phase 3: kernels 16 and 17 run only there) and, last, the
result line
``{"ok": true, "device": {...}}``; both only when every phase ran
(``--phases`` picks a subset for a quick check after an edit, ``--paths``
a subset of phase 4's paths).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
L2_BYTES = 50e6                     # H100 SXM L2 cache
PEAK_OPS = {"bfloat16": 989e12,     # dense tensor-core bf16
            "float32": 67e12,       # f32 outside the tensor cores
            "int8": 1979e12}        # dense tensor-core int8
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# the INT8 kernels: f32 outputs within this share of the output's largest
# magnitude (f32 sums in another order); bf16 outputs of quantized_matmul
# and of the decode attention kernels (every form of 4, 13, 17) within one
# bf16 ulp beyond that; the fused kernels (which also round
# intermediates to bf16) within TOL["bfloat16"] of the output's standard
# deviation
F32_REL = 1e-5
LOGIT_TOL = 1e-3
# INT8 KV: card and CPU compute k/v in another summation order, so a value
# at a rounding midpoint may take the neighbouring int8 code; one code
# step is absmax / 127 of its row. While both caches hold the same codes
# the logits are held to LOGIT_TOL; once a code is one apart, to this
# (at 7B width, 2 layers, the first such step measured 1.3e-3 on an NVIDIA
# H100 80GB HBM3 at 700.00 W; a wrong scale or a dropped key moves whole
# rows of codes)
LOGIT_TOL_CODE_APART = 1e-2
RATE_RUNS = 5                       # engine runs per length for the rate
SPEC_RATE_RUNS = 2                  # the same, per engine on the spec paths
DRAFT_RATE_RUNS = 3                 # and on the draft paths
DRAFT_TOKENS = 4                    # spec_tokens of the `draft` path
DRAFT_LAYERS = 4                    # the drafters' depth (`draft`: TinyLlama
                                    # of 22, `gemma2_draft`: Gemma-2-2B of 26)
PHASES = ("device", "build", "kernels", "engine", "cpu")

KERNELS = {
    "paged_append_decode": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:54"),
    "paged_append_prefill": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:129"),
    "flash_prefill": dict(
        source="simplellminference_tpu_torch/csrc/flash_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/flash_prefill.py:102"),
    "paged_flash_decode": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "quantized_matmul": dict(
        source="simplellminference_tpu_torch/csrc/quantized_matmul.cu",
        replaces="simplellminference_tpu/ops/matmul.py:522"),
    # kernel 5's tensor-core regime (M > 8, bf16 activations): its
    # launches apart; quantized_matmul's count holds every regime's
    "quantized_matmul_mma": dict(
        source="simplellminference_tpu_torch/csrc/quantized_matmul_mma.cu",
        replaces="simplellminference_tpu/ops/matmul.py:522"),
    # its few-rows tensor-core regime (M <= 8, bf16 activations, per-channel
    # scales, K and N multiples of 64: mma.sync; 5r): its launches apart
    "quantized_matmul_rows_mma": dict(
        source="simplellminference_tpu_torch/csrc/quantized_matmul_rows_mma.cu",
        replaces="simplellminference_tpu/ops/matmul.py:522"),
    "fused_qkv_append": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    # kernel 6's tensor-core regime (bf16 rows, H a multiple of 64, the qkv
    # columns of 128: mma.sync; 6m), its four forms together (6, 6d, 6q,
    # 6k): its launches apart; each form's row counts every call of it
    "fused_qkv_append_mma": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused_mma.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    "fused_ffn": dict(
        source="simplellminference_tpu_torch/csrc/ffn_fused.cu",
        replaces="simplellminference_tpu/ops/ffn_fused.py:138"),
    # kernel 7's tensor-core regime (bf16 activations, H and I multiples of
    # 64: mma.sync, all rows in one weight pass): its launches apart;
    # fused_ffn's count holds every call
    "fused_ffn_mma": dict(
        source="simplellminference_tpu_torch/csrc/ffn_fused_mma.cu",
        replaces="simplellminference_tpu/ops/ffn_fused.py:138"),
    "paged_flash_prefill": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_append_decode_quant": dict(
        source="simplellminference_tpu_torch/csrc/paged_append_quant.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:210"),
    "paged_append_prefill_quant": dict(
        source="simplellminference_tpu_torch/csrc/paged_append_quant.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:295"),
    # the INT8-KV forms of kernels 4, 6 and 8 (scale pools given)
    "paged_flash_decode_int8kv": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "fused_qkv_append_int8kv": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    "paged_flash_prefill_int8kv": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    # speculative decoding: kernel 11 and the verify form of kernel 4
    # (S rows per sequence; 4vq over INT8 KV)
    "paged_append_span": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:392"),
    "paged_flash_verify": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_int8kv": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    # the dense path: kernels 12 and 13 and the dense-arena form of 6
    "kv_append": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/kv_append.py:63"),
    "flash_decode": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "fused_qkv_append_dense": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    # INT4 weights (14, and 14z with AWQ/GPTQ zero points) and W8A8 (15)
    "quantized_matmul_int4": dict(
        source="simplellminference_tpu_torch/csrc/quantized_matmul_int4.cu",
        replaces="simplellminference_tpu/ops/matmul.py:354"),
    "quantized_matmul_int4_zs": dict(
        source="simplellminference_tpu_torch/csrc/quantized_matmul_int4.cu",
        replaces="simplellminference_tpu/ops/matmul.py:354"),
    # the INT4 product's tensor-core regimes (bf16 activations), both forms
    # together: mma.sync for M <= 8, wgmma for more rows; the two rows
    # above count every launch of their form, these each regime's
    "quantized_matmul_int4_mma": dict(
        source="simplellminference_tpu_torch/csrc/quantized_matmul_int4_mma.cu",
        replaces="simplellminference_tpu/ops/matmul.py:354"),
    "quantized_matmul_int4_wgmma": dict(
        source="simplellminference_tpu_torch/csrc/"
               "quantized_matmul_int4_wgmma.cu",
        replaces="simplellminference_tpu/ops/matmul.py:354"),
    "quantized_matmul_w8a8": dict(
        source="simplellminference_tpu_torch/csrc/quantized_matmul_w8a8.cu",
        replaces="simplellminference_tpu/ops/matmul.py:232"),
    # kernel 15's int8 tensor-core regime (wgmma s8, K and N multiples of
    # 16, groups of a multiple of 128): its launches apart
    "quantized_matmul_w8a8_wgmma": dict(
        source="simplellminference_tpu_torch/csrc/"
               "quantized_matmul_w8a8_wgmma.cu",
        replaces="simplellminference_tpu/ops/matmul.py:232"),
    # sliding windows: the window forms of kernels 3, 4 (4w, 4qw, 4vw,
    # 4vqw) and 8 (8w, 8qw), and the kv_layer form of 6 (6k)
    "flash_prefill_window": dict(
        source="simplellminference_tpu_torch/csrc/flash_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/flash_prefill.py:102"),
    "paged_flash_decode_window": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_decode_int8kv_window": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_verify_window": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_int8kv_window": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_prefill_window": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_flash_prefill_int8kv_window": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "fused_qkv_append_kv_layer": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    # FP8 (e4m3) KV: the e4m3 forms of kernels 1, 2, 11 (1e, 2e, 11e), 4
    # (4e, 4ve), 6 (6e) and 8 (8e)
    "paged_append_decode_fp8kv": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:54"),
    "paged_append_prefill_fp8kv": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:129"),
    "paged_append_span_fp8kv": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:392"),
    "paged_flash_decode_fp8kv": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_verify_fp8kv": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "fused_qkv_append_fp8kv": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    "paged_flash_prefill_fp8kv": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    # head_dim 256 (Gemma-2B): the D-256 forms of kernels 3, 4, 8, 13 and 6
    # (6m on bf16 rows, the FMA kernel on f32 ones); each launch also
    # counts in its form's row above
    "flash_prefill_d256": dict(
        source="simplellminference_tpu_torch/csrc/flash_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/flash_prefill.py:102"),
    "paged_flash_decode_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_prefill_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "flash_decode_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "fused_qkv_append_mma_d256": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused_mma.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    "fused_qkv_append_d256": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    # Gemma-2-2B: Gemma-2's attention soft cap in kernels 3, 4 and 8 and
    # their window forms at head_dim 256 (3c, 3wc, 4c, 4wc, 8c, 8wc), and
    # the kv_layer form 6k at D 256; each launch also counts in its form's
    # row above (and the uncapped rows' D-256 count where it has one)
    "flash_prefill_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/flash_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/flash_prefill.py:102"),
    "flash_prefill_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/flash_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/flash_prefill.py:102"),
    "paged_flash_decode_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_decode_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_prefill_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_flash_prefill_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "fused_qkv_append_kv_layer_d256": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused_mma.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    # gpt-oss-20b: GPT-OSS's attention sinks in kernels 3, 4 (decode rows)
    # and 8 and their window forms at head_dim 64 (3s, 3ws, 4s, 4ws, 8s,
    # 8ws); each launch also counts in its form's row above
    "flash_prefill_sinks": dict(
        source="simplellminference_tpu_torch/csrc/flash_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/flash_prefill.py:102"),
    "flash_prefill_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/flash_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/flash_prefill.py:102"),
    "paged_flash_decode_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_decode_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_prefill_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_flash_prefill_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    # Gemma-2 on the dense arena and under speculation: the window form of
    # kernel 13 (13w, every head dim; capped launches too), its capped
    # forms at head_dim 256 (13c, 13wc), and the verify forms of kernel 4
    # at head_dim 256 (4v, 4vw) and capped (4vc, 4vwc); each launch also
    # counts in its form's row above
    "flash_decode_window": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "flash_decode_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "flash_decode_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "paged_flash_verify_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_window_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    # gpt-oss-20b under speculation and through the Generator: sinks on
    # verify rows (4vs, 4vws) and on the dense arena (13s, 13ws) at
    # head_dim 64; each launch also counts in its form's row above
    "paged_flash_verify_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "flash_decode_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "flash_decode_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    # gpt-oss-20b over INT8 KV: the sink forms of kernels 4 and 8 over int8
    # pools at head_dim 64 (4qs, 4qws, 4vqs, 4vqws, 8qs, 8qws); each launch
    # also counts in its INT8-KV form's row above
    "paged_flash_decode_int8kv_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_decode_int8kv_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_verify_int8kv_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_int8kv_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_prefill_int8kv_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_flash_prefill_int8kv_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    # Gemma-1 over INT8 KV: the INT8-KV forms of kernels 4 and 8 at head_dim
    # 256 (4q, 4qw, 4vq, 4vqw, 8q, 8qw /256; the window forms on no path)
    "paged_flash_decode_int8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_decode_int8kv_window_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_verify_int8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_int8kv_window_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_prefill_int8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_flash_prefill_int8kv_window_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    # Gemma-2 over INT8 KV: the capped INT8-KV forms at head_dim 256 (4qc,
    # 4qwc, 4vqc, 4vqwc, 8qc, 8qwc /256)
    "paged_flash_decode_int8kv_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_decode_int8kv_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_verify_int8kv_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_int8kv_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_prefill_int8kv_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_flash_prefill_int8kv_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    # the quantizing fused qkv (6q) and writes (9, 10) at head_dim 256: 6q
    # on either kernel, its launches with a kv_layer (the grouped engine's
    # INT8 ring pools) apart too
    "fused_qkv_append_int8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused_mma.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    "fused_qkv_append_int8kv_kv_layer_d256": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused_mma.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    "paged_append_decode_quant_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_append_quant.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:210"),
    "paged_append_prefill_quant_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_append_quant.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:295"),
    # FP8 KV with sliding windows and sinks (head_dim <= 128): the window
    # forms of kernels 4 and 8 over e4m3 pools (4ew, 4vew, 8ew: Mistral-7B
    # over the grouped engine's e4m3 ring pools), 6 with a kv_layer (6ek),
    # and gpt-oss-20b's sink forms over e4m3 pools at head_dim 64 (4es,
    # 4ews, 4ves, 4vews, 8es, 8ews); each launch also counts in its FP8-KV
    # form's row above
    "paged_flash_decode_fp8kv_window": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_verify_fp8kv_window": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_prefill_fp8kv_window": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "fused_qkv_append_fp8kv_kv_layer": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused_mma.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    "paged_flash_decode_fp8kv_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_decode_fp8kv_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_verify_fp8kv_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_fp8kv_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_prefill_fp8kv_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_flash_prefill_fp8kv_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    # Gemma over FP8 KV: the capped e4m3 forms of kernels 4 and 8 at head
    # dim 256 (4ec, 4ewc, 4vec, 4vewc, 8ec, 8ewc; Gemma-2) and the e4m3
    # forms at D 256 (4e, 4ew, 4ve, 4vew, 8e, 8ew; the writes 1e, 2e, 11e;
    # the fused qkv 6e and, with a kv_layer, 6ek); each launch also counts
    # in its FP8-KV form's row above
    "paged_flash_decode_fp8kv_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_decode_fp8kv_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_verify_fp8kv_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_fp8kv_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_prefill_fp8kv_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_flash_prefill_fp8kv_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_flash_decode_fp8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_decode_fp8kv_window_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_verify_fp8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_verify_fp8kv_window_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:136"),
    "paged_flash_prefill_fp8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_flash_prefill_fp8kv_window_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    "paged_append_decode_fp8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:54"),
    "paged_append_prefill_fp8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:129"),
    "paged_append_span_fp8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:392"),
    "fused_qkv_append_fp8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused_mma.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    "fused_qkv_append_fp8kv_kv_layer_d256": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused_mma.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    # FP8 KV on the dense arena: the e4m3 forms of kernels 12 (12e), 13
    # (13e, 13ew; capped at D 256, 13ec, 13ewc; with sinks at D 64, 13es,
    # 13ews) and 6d (6de: the FP8-KV form with tables=None); each D-256,
    # capped or sink launch also counts in its form's row
    "kv_append_fp8kv": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/kv_append.py:63"),
    "kv_append_fp8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/paged_append.cu",
        replaces="simplellminference_tpu/ops/kv_append.py:63"),
    "flash_decode_fp8kv": dict(
        source="simplellminference_tpu_torch/csrc/flash_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "flash_decode_fp8kv_window": dict(
        source="simplellminference_tpu_torch/csrc/flash_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "flash_decode_fp8kv_d256": dict(
        source="simplellminference_tpu_torch/csrc/flash_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "flash_decode_fp8kv_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/flash_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "flash_decode_fp8kv_window_cap_d256": dict(
        source="simplellminference_tpu_torch/csrc/flash_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "flash_decode_fp8kv_sinks": dict(
        source="simplellminference_tpu_torch/csrc/flash_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "flash_decode_fp8kv_window_sinks": dict(
        source="simplellminference_tpu_torch/csrc/flash_decode_e4m3.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode.py:114"),
    "fused_qkv_append_fp8kv_dense": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused_mma.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    "fused_qkv_append_fp8kv_dense_d256": dict(
        source="simplellminference_tpu_torch/csrc/qkv_fused_mma.cu",
        replaces="simplellminference_tpu/ops/qkv_fused.py:229"),
    # absorbed MLA (DeepSeek-V2-Lite's attention, one shared latent pool):
    # the shared-KV forms of kernels 1 (1l), 2 (2l), 3 (3l), 4 (4l) and 8
    # (8l); their launches on the `mla` path at D 640
    "paged_append_decode_shared": dict(
        source="simplellminference_tpu_torch/csrc/paged_append_shared.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:54"),
    "paged_append_prefill_shared": dict(
        source="simplellminference_tpu_torch/csrc/paged_append_shared.cu",
        replaces="simplellminference_tpu/ops/paged_append.py:129"),
    "flash_prefill_shared": dict(
        source="simplellminference_tpu_torch/csrc/flash_prefill_shared.cu",
        replaces="simplellminference_tpu/ops/attention/flash_prefill.py:102"),
    "paged_flash_decode_shared": dict(
        source="simplellminference_tpu_torch/csrc/paged_decode_shared.cu",
        replaces="simplellminference_tpu/ops/attention/paged_decode.py:165"),
    "paged_flash_prefill_shared": dict(
        source="simplellminference_tpu_torch/csrc/paged_prefill_shared.cu",
        replaces="simplellminference_tpu/ops/attention/paged_prefill.py:156"),
    # the last two TPU kernels, dispatched from no path (as in JAX)
    "fused_wo_ffn": dict(
        source="simplellminference_tpu_torch/csrc/wo_ffn.cu",
        replaces="simplellminference_tpu/ops/ffn_fused.py:302"),
    "flash_decode_dyn": dict(
        source="simplellminference_tpu_torch/csrc/flash_decode_dyn.cu",
        replaces="simplellminference_tpu/ops/attention/flash_decode_dyn.py:105"),
}
# the Engine's paths, in order: bench.py's weight paths (prefix cache
# off), then the server's default configuration (prefix cache on,
# chunked prefill) with INT8 weights, then INT8 KV: bench.py
# --kv-dtype int8 (INT8 weights) and the server CLI's --kv-dtype int8
# (bf16 weights, the prefix cache on); then prompt-lookup speculation:
# the server CLI's --spec-tokens 4 (bf16 weights and KV, the prefix cache
# on) and bench.py --kv-dtype int8 with spec_tokens=4; then FP8 KV as the
# INT8-KV paths run: bench.py --kv-dtype fp8, the server CLI's --kv-dtype
# fp8 and spec_tokens=4 over fp8 KV (INT8 weights); then the dense
# path: bench.py's Generator (INT8 weights, and bf16 under --fp) and
# draft-model speculation (the spec engine drafted by TinyLlama-1.1B); then
# bench.py --quant int4 through the Engine (`int4`) and the Generator
# (`int4_dense`), and the server CLI's --act-quant (W8A8 prefill) on the
# prefix path's traffic; then sliding windows at Mistral-7B width through
# the grouped engine; then Gemma-2B (head_dim 256, one kv head, GeGLU,
# a tied bf16 head) as bench.py draws its default INT8 path and as the
# server serves it by default (bf16 weights, the prefix path's traffic);
# then Gemma-2-2B (soft caps, sandwich norms, alternating sliding and full
# layers at head_dim 256) as bench.py draws its INT8 path and, with bf16
# weights and chunked prefill, over prompts past its window; then Gemma-2
# on the dense arena and under speculation: bench.py's Generator over
# prompts past the window (INT8 weights), the server CLI's --spec-tokens 4
# (bf16) and Gemma-2-9B drafted by Gemma-2-2B (bf16); then gpt-oss-20b
# (attention sinks, the mixture of experts, biases, alternating sliding
# and full layers at head_dim 64) as bench.py draws its INT8 path and as
# the server serves it by default (bf16 weights, the prefix path's
# traffic); then gpt-oss-20b under the server CLI's --spec-tokens 4
# (bf16, and over INT8 KV on the prefix traffic) and through bench.py's
# Generator (INT8); INT8 and FP8 KV for gpt-oss-20b (bench.py --kv-dtype
# int8 and fp8; the server CLI's --kv-dtype fp8 --spec-tokens 4 on the
# prefix traffic), its paths ordered so that those of one weight draw
# (INT8, then bf16) run one after the other and share it; then INT8 and
# FP8 KV for Gemma-2B (the server's prefix traffic, INT8 weights) and
# Gemma-2-2B (bench.py --kv-dtype int8 and fp8, and --spec-tokens 4 on the
# prefix traffic), each FP8-KV path after its INT8-KV twin, whose draw it
# shares; FP8 KV on the dense arena (bench.py's Generator with
# --kv-dtype fp8 at Llama-2-7B, Gemma-2-2B and gpt-oss-20b, INT8 weights),
# each right after its bf16-KV twin, whose draw it shares; and last
# absorbed MLA through the Engine as benchmarks/bench_mla.py runs it
# (DeepSeek-V2-Lite's attention geometry: `mla`, one shared latent pool)
# and its naive twin (`mla_naive`, per-head K/V at D 256), one draw
PATHS = ("int8", "bf16", "prefix", "int8kv", "int8kv_prefix", "spec",
         "spec_int8kv", "fp8kv", "fp8kv_prefix", "spec_fp8kv", "dense",
         "dense_fp8kv", "dense_bf16", "draft", "int4", "int4_dense", "w8a8",
         "mistral_window", "gemma", "gemma_prefix", "gemma2",
         "gemma2_window", "gemma2_dense", "gemma2_dense_fp8kv",
         "gemma2_spec", "gemma2_draft", "gpt_oss", "gpt_oss_dense",
         "gpt_oss_dense_fp8kv", "gpt_oss_int8kv", "gpt_oss_fp8kv",
         "gpt_oss_prefix", "gpt_oss_spec", "gpt_oss_spec_int8kv",
         "gpt_oss_spec_fp8kv", "gemma_int8kv_prefix", "gemma_fp8kv_prefix",
         "gemma2_int8kv", "gemma2_fp8kv", "gemma2_spec_int8kv",
         "gemma2_spec_fp8kv", "mla", "mla_naive")
# each FP8-KV path of the Gemmas and its INT8-KV twin, each FP8-KV dense
# path and its bf16-KV twin, and naive MLA and its absorbed twin, whose
# device step, bytes floor and idle share it prints beside its own
TWINS = {"gemma_fp8kv_prefix": "gemma_int8kv_prefix",
         "gemma2_fp8kv": "gemma2_int8kv",
         "gemma2_spec_fp8kv": "gemma2_spec_int8kv",
         "dense_fp8kv": "dense", "gemma2_dense_fp8kv": "gemma2_dense",
         "gpt_oss_dense_fp8kv": "gpt_oss_dense", "mla_naive": "mla"}
# each path's decode (or verify) step: engine ms, device ms, floor ms,
# idle share (filled by the serve functions)
STEPS: dict = {}
# google/gemma-2-2b's config.json (huggingface.co/google/gemma-2-2b), the
# published values the Gemma-2 paths serve; its layer_types as
# transformers.Gemma2Config derives them: sliding on even layers, full on
# odd ones
GEMMA2_2B_HF = dict(
    model_type="gemma2", vocab_size=256000, hidden_size=2304,
    intermediate_size=9216, num_hidden_layers=26, num_attention_heads=8,
    num_key_value_heads=4, head_dim=256, max_position_embeddings=8192,
    rms_norm_eps=1e-6, rope_theta=10000.0,
    hidden_activation="gelu_pytorch_tanh", hidden_act="gelu_pytorch_tanh",
    query_pre_attn_scalar=256, sliding_window=4096,
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    tie_word_embeddings=True)


# google/gemma-2-9b's config.json (huggingface.co/google/gemma-2-9b): the
# target the `gemma2_draft` path serves, drafted by Gemma-2-2B
GEMMA2_9B_HF = dict(
    GEMMA2_2B_HF, hidden_size=3584, intermediate_size=14336,
    num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8)


def _gemma2(hf: dict, num_layers: int, dtype: str):
    """A Gemma-2 ModelConfig from its config.json values through the
    port's ``from_hf_dict`` (depth ``num_layers``: the alternation kept)."""
    from simplellminference_tpu_torch.core.config import ModelConfig
    d = dict(hf, num_hidden_layers=num_layers, layer_types=[
        "sliding_attention" if i % 2 == 0 else "full_attention"
        for i in range(num_layers)])
    return ModelConfig.from_hf_dict(d, dtype=dtype)


def gemma2_2b(num_layers: int = 26, dtype: str = "bfloat16"):
    """Gemma-2-2B's ModelConfig from :data:`GEMMA2_2B_HF`."""
    return _gemma2(GEMMA2_2B_HF, num_layers, dtype)


def gemma2_9b(num_layers: int = 42, dtype: str = "bfloat16"):
    """Gemma-2-9B's ModelConfig from :data:`GEMMA2_9B_HF`."""
    return _gemma2(GEMMA2_9B_HF, num_layers, dtype)


# openai/gpt-oss-20b's config.json (huggingface.co/openai/gpt-oss-20b):
# the published values the `gpt_oss` paths serve (transformers'
# GptOssConfig() defaults are gpt-oss-120b's: 36 layers, 128 experts);
# its layer_types: sliding on even layers, full on odd ones
GPT_OSS_20B_HF = dict(
    model_type="gpt_oss", vocab_size=201088, hidden_size=2880,
    intermediate_size=2880, num_hidden_layers=24, num_attention_heads=64,
    num_key_value_heads=8, head_dim=64, num_local_experts=32,
    num_experts_per_tok=4, experts_per_token=4, tie_word_embeddings=False,
    attention_bias=True, sliding_window=128, rope_theta=150000.0,
    rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "original_max_position_embeddings": 4096,
                  "truncate": False},
    max_position_embeddings=131072, rms_norm_eps=1e-5, swiglu_limit=7.0,
    hidden_act="silu", initial_context_length=4096)


def gpt_oss_20b(num_layers: int = 24, dtype: str = "bfloat16"):
    """gpt-oss-20b's ModelConfig from :data:`GPT_OSS_20B_HF` through the
    port's ``from_hf_dict`` (depth ``num_layers``: the alternation
    kept)."""
    from simplellminference_tpu_torch.core.config import ModelConfig
    d = dict(GPT_OSS_20B_HF, num_hidden_layers=num_layers, layer_types=[
        "sliding_attention" if i % 2 == 0 else "full_attention"
        for i in range(num_layers)])
    return ModelConfig.from_hf_dict(d, dtype=dtype)
# every launch of phase 3, by kernel (filled by phase_kernels)
phase3_launches: dict = {}


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- helpers

class Laps:
    """Seconds between the marks of a phase, summed by name and printed as
    one JSON line: where the phase's time goes."""

    def __init__(self):
        self.t, self.laps = time.perf_counter(), {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = round(self.laps.get(name, 0.0) + now - self.t, 1)
        self.t = now

    def print(self, phase: str) -> None:
        print(f"[timing] seconds per {phase} step {json.dumps(self.laps)}",
              flush=True)


def time_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: the calls are captured into a
    CUDA graph and replayed, so host launch cost does not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def dname(torch, dt) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------- phases

def phase_device(torch):
    require(torch.cuda.is_available(), "CUDA is not available")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    print(f"[device] {name} x{count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi_line, flush=True)
    return name, count, smi_line


def phase_build():
    from simplellminference_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    cuda_build.load()
    info = cuda_build.build_info
    print(f"[build] {len(cuda_build.sources())} sources -> "
          f"{info['dir']} in {time.perf_counter() - t0:.1f} s "
          f"(cached={info['cached']})", flush=True)
    if info.get("source_seconds"):
        slow = sorted(info["source_seconds"].items(), key=lambda kv: -kv[1])
        print(f"[build] seconds per source (nvcc, all at once): "
              f"{json.dumps({k: round(v, 1) for k, v in slow})}", flush=True)
    for line in info.get("ptxas", "").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip(), flush=True)
    return HgmmaCount(Path(info["dir"]) / cuda_build.LIB_NAME)


# the tensor-core kernels whose SASS phase 2 searches, and for which
# instruction: HGMMA (wgmma) or HMMA (mma.sync)
MMA_KERNELS = {"flash_prefill_mma_kernel": "HGMMA",
               "paged_prefill_mma_kernel": "HGMMA",
               "qmm_mma_kernel": "HGMMA", "qmm4_wgmma_kernel": "HGMMA",
               "qmm4_mma_rows_kernel": "HMMA",
               "qmm_w8a8_wgmma_kernel": "IGMMA",
               "ffn_gate_up_mma_kernel": "HMMA",
               "ffn_down_mma_kernel": "HMMA",
               "qkv_fused_mma_kernel": "HMMA",
               "qmm_rows_mma_kernel": "HMMA",
               "flash_prefill_shared_mma_kernel": "HGMMA",
               "paged_prefill_shared_mma_kernel": "HGMMA"}


class HgmmaCount:
    """Tensor-core evidence: the HGMMA, IGMMA (integer wgmma) or HMMA
    instructions in the SASS of each instantiation of MMA_KERNELS
    (``cuobjdump -sass``), or a line saying cuobjdump is not there. The
    disassembly (some 40 s of host time) runs while the phases do, a
    thread counting its lines as they come (left unread, the pipe would
    fill and stall cuobjdump until :meth:`print`); :meth:`print` waits for
    it, :meth:`stop` ends it unread."""

    def __init__(self, lib: Path):
        import shutil
        import threading

        from simplellminference_tpu_torch.ops import cuda_build
        cand = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
        tool = str(cand) if cand.is_file() else shutil.which("cuobjdump")
        self.counts: dict = {}
        self.proc = self.reader = None
        if tool is not None:
            self.proc = subprocess.Popen(
                [tool, "-sass", str(lib)], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
            self.reader = threading.Thread(
                target=count_mma, args=(self.proc.stdout, self.counts),
                daemon=True)
            self.reader.start()

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def print(self) -> None:
        if self.proc is None:
            print("[build] cuobjdump not found: no SASS evidence of HGMMA",
                  flush=True)
            return
        self.proc.wait(timeout=300)
        self.reader.join(timeout=300)
        print_hgmma(self.counts)


def count_mma(lines, counts: dict) -> None:
    """Count the HGMMA, HMMA and IGMMA instructions of each function in
    the ``cuobjdump -sass`` output ``lines`` into ``counts``."""
    fn = None
    for line in lines:
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts.setdefault(fn, {"HGMMA": 0, "HMMA": 0, "IGMMA": 0})
        elif fn is not None:
            for op in ("HGMMA", "HMMA", "IGMMA"):
                if f" {op}." in line or f" {op} " in line:
                    counts[fn][op] += 1


def print_hgmma(counts: dict) -> None:
    """The instruction counts of :class:`HgmmaCount` (:func:`count_mma`)
    of each instantiation of MMA_KERNELS."""
    import re
    for kname, op in MMA_KERNELS.items():
        for fn, n in sorted(counts.items()):
            if kname not in fn:
                continue
            args = re.search(kname + r"I(.*?)EEv", fn)
            print(f"[build] {op} in {kname}<"
                  f"{args.group(1) if args else '?'}>: {n[op]}", flush=True)


def _pools(torch, gen, dev, layers, pages, kvn, ps, d, dtype):
    shape = (layers, pages + 1, kvn, ps, d)
    return (torch.randn(shape, generator=gen, device=dev, dtype=dtype),
            torch.randn(shape, generator=gen, device=dev, dtype=dtype))


def _tables(torch, dev, b, mp, dead_last=True):
    t = torch.arange(b * mp, dtype=torch.int32, device=dev).reshape(b, mp)
    t = t.flip(1).contiguous()      # non-trivial page order
    if dead_last:
        t[-1] = -1                  # an inactive slot: every entry unmapped
    return t


def check_append_decode(torch, dev, results):
    from simplellminference_tpu_torch.ops.paged_append import (
        paged_append_decode, paged_append_decode_ref)
    gen = torch.Generator(device=dev).manual_seed(1)
    main = None
    for tag, (b, kvn, d, dtype) in {
            "llama2-7b": (8, 32, 128, torch.bfloat16),
            "gqa": (8, 4, 64, torch.float32)}.items():
        ps, mp, layer = 128, 3, 1
        pk, pv = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, dtype)
        nk = torch.randn((b, kvn, d), generator=gen, device=dev, dtype=dtype)
        qkv = torch.randn((b, 3 * kvn * d), generator=gen, device=dev,
                          dtype=dtype)
        nv = qkv[:, 2 * kvn * d:].reshape(b, kvn, d)   # strided, like the model
        tables = _tables(torch, dev, b, mp)
        pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
        ka, va, kb, vb = pk.clone(), pv.clone(), pk.clone(), pv.clone()
        paged_append_decode(ka, va, nk, nv, tables, pos, layer)
        paged_append_decode_ref(kb, vb, nk, nv, tables, pos, layer)
        torch.cuda.synchronize()
        err = max(max_err(ka[:, :-1], kb[:, :-1]),
                  max_err(va[:, :-1], vb[:, :-1]))
        print(f"[kernels] paged_append_decode {tag}: max|err| {err} "
              f"(tol 0, exact; trash page excluded)", flush=True)
        require(err == 0.0, f"paged_append_decode {tag} disagrees: {err}")
        if main is None:
            p1 = pk.shape[1]
            page = torch.where(tables.long().gather(
                1, (pos.long() // ps)[:, None])[:, 0] >= 0,
                tables.long().gather(1, (pos.long() // ps)[:, None])[:, 0],
                p1 - 1)
            slot = (pos.long() % ps)
            heads = torch.arange(kvn, device=dev)

            def library():
                ka[layer].index_put_((page[:, None], heads[None],
                                      slot[:, None]), nk)
                va[layer].index_put_((page[:, None], heads[None],
                                      slot[:, None]), nv)

            es = pk.element_size()
            nbytes = (2 * b * kvn * d * es * 2 + tables.numel() * 4
                      + pos.numel() * 4)
            bms, by = bound_ms(nbytes, 0.0, dname(torch, dtype))
            main = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: paged_append_decode(
                    ka, va, nk, nv, tables, pos, layer)),
                plain_ms=time_ms(torch, lambda: paged_append_decode_ref(
                    kb, vb, nk, nv, tables, pos, layer)),
                library_ms=time_ms(torch, library),
                bound_ms=bms, bound_by=by)
    results["paged_append_decode"] = main


def check_append_prefill(torch, dev, results):
    from simplellminference_tpu_torch.ops.paged_append import (
        paged_append_prefill, paged_append_prefill_ref)
    gen = torch.Generator(device=dev).manual_seed(2)
    main = None
    for tag, (b, s, kvn, d, dtype) in {
            "llama2-7b": (8, 128, 32, 128, torch.bfloat16),
            "ragged": (8, 100, 32, 128, torch.bfloat16),
            "gqa": (4, 300, 4, 64, torch.float32)}.items():
        ps, mp, layer = 128, 3, 0
        pk, pv = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, dtype)
        qkv = torch.randn((b, s, 3 * kvn * d), generator=gen, device=dev,
                          dtype=dtype)
        nk = qkv[..., kvn * d:2 * kvn * d].reshape(b, s, kvn, d).contiguous()
        nv = qkv[..., 2 * kvn * d:].reshape(b, s, kvn, d)   # strided view
        tables = _tables(torch, dev, b, mp)
        ka, va, kb, vb = pk.clone(), pv.clone(), pk.clone(), pv.clone()
        paged_append_prefill(ka, va, nk, nv, tables, layer)
        paged_append_prefill_ref(kb, vb, nk, nv, tables, layer)
        torch.cuda.synchronize()
        err = max(max_err(ka[:, :-1], kb[:, :-1]),
                  max_err(va[:, :-1], vb[:, :-1]))
        print(f"[kernels] paged_append_prefill {tag}: max|err| {err} "
              f"(tol 0, exact; trash page excluded)", flush=True)
        require(err == 0.0, f"paged_append_prefill {tag} disagrees: {err}")
        if main is None:
            npg = -(-s // ps)
            p1 = pk.shape[1]
            idx = tables[:, :npg].long()
            idx = torch.where(idx >= 0, idx, p1 - 1).reshape(-1)
            ck = nk.reshape(b, npg, ps, kvn, d).permute(
                0, 1, 3, 2, 4).reshape(b * npg, kvn, ps, d).contiguous()
            cv = nv.reshape(b, npg, ps, kvn, d).permute(
                0, 1, 3, 2, 4).reshape(b * npg, kvn, ps, d).contiguous()

            def library():
                ka[layer].index_copy_(0, idx, ck)
                va[layer].index_copy_(0, idx, cv)

            es = pk.element_size()
            nbytes = (2 * b * s * kvn * d * es
                      + 2 * b * npg * ps * kvn * d * es + b * mp * 4)
            bms, by = bound_ms(nbytes, 0.0, dname(torch, dtype))
            main = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: paged_append_prefill(
                    ka, va, nk, nv, tables, layer)),
                plain_ms=time_ms(torch, lambda: paged_append_prefill_ref(
                    kb, vb, nk, nv, tables, layer)),
                library_ms=time_ms(torch, library),
                bound_ms=bms, bound_by=by)
    results["paged_append_prefill"] = main


def check_flash_prefill(torch, dev, results):
    import torch.nn.functional as F

    from simplellminference_tpu_torch.ops.attention.flash_prefill import (
        flash_prefill, flash_prefill_ref)
    gen = torch.Generator(device=dev).manual_seed(3)
    main = None
    for tag, (b, s, n, kvn, d, dtype) in {
            "llama2-7b": (8, 128, 32, 32, 128, torch.bfloat16),
            "ragged": (8, 100, 32, 32, 128, torch.bfloat16),
            "gqa-f32": (2, 100, 32, 4, 64, torch.float32),
            "gqa-bf16": (2, 256, 32, 4, 64, torch.bfloat16)}.items():
        q = torch.randn((b, s, n, d), generator=gen, device=dev, dtype=dtype)
        k = torch.randn((b, s, kvn, d), generator=gen, device=dev,
                        dtype=dtype)
        vbig = torch.randn((b, s, 3 * kvn * d), generator=gen, device=dev,
                           dtype=dtype)
        v = vbig[..., 2 * kvn * d:].reshape(b, s, kvn, d)   # strided view
        got = flash_prefill(q, k, v)
        want = flash_prefill_ref(q, k, v)
        torch.cuda.synchronize()
        ok, err, note = _prefill_rule(torch, got, want)
        print(f"[kernels] flash_prefill {tag}: max|err| {err:.3e} ({note})",
              flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"flash_prefill {tag} disagrees: {err} ({note})")
        if main is None:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            es = q.element_size()
            nbytes = (2 * b * s * n * d + 2 * b * s * kvn * d) * es
            ops = 4.0 * b * n * d * s * (s + 1) / 2
            bms, by = bound_ms(nbytes, ops, dname(torch, dtype))
            main = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: flash_prefill(q, k, v)),
                plain_ms=time_ms(torch, lambda: flash_prefill_ref(q, k, v)),
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)),
                bound_ms=bms, bound_by=by)
    results["flash_prefill"] = main


def _split_edge_lens(kvn, span, wins=1, rows=1):
    """Batches of kv_lens for the split edges of kernel 4's key walk: 1,
    every boundary of the splits over the whole span +- 1 and the span
    itself, each batch as large as keeps more than one split (a wave of two
    blocks per SM), sequence 0 at kv_len 0, the last a pad (a dead slot's
    row where the caller wants one)."""
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    rb = pd.row_blocks(rows)
    b = max(i for i in range(2, 65) if pd.decode_splits(i, kvn, span, rb) > 1)
    z = pd.decode_splits(b, kvn, span, rb)
    cuts = [lo for lo, _hi in pd.split_keys(span, wins, 0, span, z)][1:]
    edges = sorted({min(span, c + e) for c in cuts for e in (-1, 0, 1)}
                   | {1, span - 1, span})
    require(b >= 4, f"split edges: {b} sequences")
    return [([0] + edges[i:i + b - 2] + [wins + 7 * j for j in range(b)])[:b]
            for i in range(0, len(edges), b - 2)]


def _attn_check(torch, name, tag, got, want, dead=None):
    """Kernel 4's forms and 13 against their plain versions by
    :func:`_rounding_rule`; rows ``dead`` (kv_len 0, or an all -1 table)
    must be zero."""
    ok, err, share, note = _rounding_rule(torch, got, want)
    zero = all(bool((got[i] == 0).all()) for i in (dead or []))
    print(f"[kernels] {name} {tag}: max|err| {err:.3e} ({note}; the worst "
          f"element at {share:.3f} of its limit); rows without keys zero: "
          f"{zero}", flush=True)
    require(bool(torch.isfinite(got).all()) and ok and zero,
            f"{name} {tag} disagrees: {err}, {share}, zero rows {zero}")
    return err


def _decode_bytes(torch, tables, kv_lens, ps, per_key):
    """KV bytes kernel 4 must read: each key below kv_len in a mapped page
    (an unmapped page reads as zeros without touching memory) once, per
    kv head ``per_key`` bytes of K and V. Returns (bytes, live keys)."""
    mp = tables.shape[1]
    key_pos = torch.arange(mp * ps, device=tables.device)
    mapped = tables.long().repeat_interleave(ps, dim=1) >= 0
    live = int((mapped & (key_pos[None] < kv_lens.long()[:, None])).sum())
    return live * per_key, live


def check_paged_decode(torch, dev, results, extra):
    """Kernel 4 against its plain version by the rounding rule: the bench
    shape (the row: 8 live rows at kv_len 128-156, as the engine's decode,
    7B), GQA f32 and bf16 with a dead slot (all -1 table, kv_len 129), the
    split edges (kv_len 0, 1, each split boundary +- 1, the span; MHA at
    D 128 and GQA at D 64, a dead slot) and the long step's shape (B 8,
    kv_len 4096, 7B; timed)."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops.attention.paged_decode import (
        paged_flash_decode, paged_flash_decode_ref)
    gen = torch.Generator(device=dev).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (n, kvn, d, dtype, lens, mp, dead slot)
    cases = {
        "llama2-7b": (32, 32, 128, bf, [128 + 4 * i for i in range(8)], 2,
                      False),
        "gqa-f32": (32, 4, 64, f32, [1, 5, 128, 200, 0, 129], 2, True),
        "gqa-bf16": (32, 4, 64, bf, [1, 5, 128, 200, 0, 129], 2, True),
        "llama2-7b kv_len 4096": (32, 32, 128, bf, [4096] * 8, 32, False),
    }
    for i, lens in enumerate(_split_edge_lens(32, 2048)):
        cases[f"split edges mha-bf16 {i}"] = (32, 32, 128, bf, lens, 16, True)
    for i, lens in enumerate(_split_edge_lens(4, 2048, rows=8)):
        cases[f"split edges gqa-f32 {i}"] = (32, 4, 64, f32, lens, 16, True)
    timed = ("llama2-7b", "llama2-7b kv_len 4096")
    for tag, (n, kvn, d, dtype, lens, mp, dead) in cases.items():
        b, ps, layer = len(lens), 128, 1
        pk, pv = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, dtype)
        q = torch.randn((b, n, d), generator=gen, device=dev, dtype=dtype)
        tables = _tables(torch, dev, b, mp, dead_last=dead)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = paged_flash_decode(q, pk, pv, tables, kv_lens, layer)
        want = paged_flash_decode_ref(q, pk, pv, tables, kv_lens, layer)
        torch.cuda.synchronize()
        zero = [i for i in range(b) if lens[i] == 0] + [b - 1] * dead
        err = _attn_check(torch, "paged_flash_decode", tag, got, want, zero)
        if tag not in timed:
            continue
        ck, cv = gather_dense(pk[layer], pv[layer], tables)
        mask = (torch.arange(ck.shape[2], device=dev)[None, None, None, :]
                < kv_lens.long()[:, None, None, None])
        q4 = q[:, :, None]
        es = q.element_size()
        kvb, live = _decode_bytes(torch, tables, kv_lens, ps,
                                  2 * kvn * d * es)
        nbytes = 2 * b * n * d * es + kvb + tables.numel() * 4 + b * 4
        bms, by = bound_ms(nbytes, 4.0 * n * d * live, dname(torch, dtype))
        res = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: paged_flash_decode(
                q, pk, pv, tables, kv_lens, layer)),
            plain_ms=time_ms(torch, lambda: paged_flash_decode_ref(
                q, pk, pv, tables, kv_lens, layer)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, ck, cv, attn_mask=mask)),
            bound_ms=bms, bound_by=by)
        extra.append(("paged_flash_decode", tag, res))
        results.setdefault("paged_flash_decode", res)
        del ck, cv


def _qweight(torch, gen, dev, shape, groups):
    """Random int8 [.., K, N] and f32 scales [.., groups, N] around bench.py's
    K**-0.5 / 127, varied per column so that a column mix-up shows."""
    q = torch.randint(-127, 128, shape, generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((*shape[:-2], groups, shape[-1]), generator=gen,
                   device=dev) + 0.5
    return q, s * (shape[-2] ** -0.5 / 127.0)


def _bf16_ulp(torch, a):
    return torch.exp2(torch.floor(torch.log2(
        a.float().abs().clamp_min(2.0 ** -100))) - 7)


def _int8pack(torch, q, s, dtype):
    """Operands of torch._weight_int8pack_mm (the library yardstick for a
    per-channel int8 product; the port never calls it): [N, K] int8 and
    [N] scales in the activation dtype."""
    return q.t().contiguous(), s.reshape(-1).to(dtype).contiguous()


class _Forced:
    """Within the block, ``module.name`` (a regime chooser) returns
    ``regime`` where it would return ``instead``: a kernel's FMA regime
    timed on the inputs its tensor-core regime takes, in the same call."""

    def __init__(self, module, name: str, instead: str, regime: str):
        self.module, self.name = module, name
        self.instead, self.regime = instead, regime

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def chooser(*a, **kw):
            r = self.orig(*a, **kw)
            return self.regime if r == self.instead else r
        setattr(self.module, self.name, chooser)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _rotating(fn, copies: int):
    """``fn(layer)`` over layers 0 .. copies - 1 in turn, one a call: each
    call reads the next copy of the weights, so a set of copies past the
    50 MB L2 is read from device memory."""
    turn = iter(range(1 << 30))
    return lambda: fn(next(turn) % copies)


def check_quantized_matmul(torch, dev, results, extra):
    from simplellminference_tpu_torch.ops import matmul as mm
    from simplellminference_tpu_torch.ops.matmul import (
        quantized_matmul, quantized_matmul_ref)
    gen = torch.Generator(device=dev).manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (m, k, n, scale groups, x dtype, out dtype); the first twelve
    # are timed: the 7B main paths' calls (wo and the LM head per decode
    # step, wqkv at the 8 x 128-token prefill, wqkv, wo and the LM head of
    # a spec_int8kv verify step at 8 x 5 rows), `mistral_window`'s chunk
    # of 256 rows (wqkv, gate_up, down) and wo at M 16, 64 and 65; so are
    # the few-rows tensor-core regime's cases (rmma: wo and the head at M 8
    # and 1), each also on the FMA kernel it replaces (forced, the same
    # inputs) and over weight copies past the L2. The 7B wo decode is the
    # row of 5r and, forced, of the FMA kernels (quantized_matmul); the
    # prefill wqkv the row of the wgmma regime (quantized_matmul_mma)
    cases = {
        "llama2-7b wo decode": (8, 4096, 4096, 1, bf, bf),
        "llama2-7b lm_head decode": (8, 4096, 32000, 1, bf, f32),
        "llama2-7b wo m1": (1, 4096, 4096, 1, bf, bf),
        "llama2-7b lm_head m1": (1, 4096, 32000, 1, bf, f32),
        "n4160 decode (odd 64-column group)": (8, 4096, 4160, 1, bf, bf),
        "llama2-7b wqkv prefill": (1024, 4096, 12288, 1, bf, bf),
        "llama2-7b wqkv verify": (40, 4096, 12288, 1, bf, bf),
        "llama2-7b wo verify": (40, 4096, 4096, 1, bf, bf),
        "llama2-7b lm_head verify": (40, 4096, 32000, 1, bf, f32),
        "mistral-7b wqkv chunk": (256, 4096, 6144, 1, bf, bf),
        "mistral-7b gate_up chunk": (256, 4096, 28672, 1, bf, bf),
        "mistral-7b down chunk": (256, 14336, 4096, 1, bf, bf),
        "llama2-7b wo m16": (16, 4096, 4096, 1, bf, bf),
        "llama2-7b wo m64": (64, 4096, 4096, 1, bf, bf),
        "llama2-7b wo m65": (65, 4096, 4096, 1, bf, bf),
        "llama2-7b wo group128": (8, 4096, 4096, 32, bf, bf),
        "llama2-7b wo prefill group128": (1024, 4096, 4096, 32, bf, f32),
        "verify group32 n4000": (40, 4096, 4000, 128, bf, bf),
        "tinyllama wqkv decode f32": (8, 2048, 2560, 1, f32, f32),
        "tinyllama w_down prefill": (512, 5632, 2048, 1, bf, bf),
        "k4000 decode f32": (8, 4000, 4096, 1, f32, f32),
        "k4000 prefill": (100, 4000, 4096, 1, bf, bf),
        "k1000 prefill group125": (100, 1000, 2048, 8, bf, f32),
        "f32 prefill": (100, 1024, 1024, 1, f32, f32),
    }
    timed = list(cases)[:15]
    for tag, (m, k, n, groups, xdt, odt) in cases.items():
        q, s = _qweight(torch, gen, dev, (2, k, n), groups)
        x = torch.randn((m, k), generator=gen, device=dev).to(xdt)
        regime = mm.tiled_regime(m, k, n, k // groups, xdt)
        got = quantized_matmul(x, q, s, out_dtype=odt, layer=1)
        want = quantized_matmul_ref(x, q, s, out_dtype=odt, layer=1)
        torch.cuda.synchronize()
        ok, err, rule = _matmul_rule(torch, got, want, odt)
        print(f"[kernels] quantized_matmul {tag} (m={m} k={k} n={n} "
              f"groups={groups}, {regime}): max|err| {err:.3e} ({rule})",
              flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"quantized_matmul {tag} disagrees: {err}")
        if regime == "rmma":
            # the FMA kernel 5r replaces, on the same inputs
            with _Forced(mm, "tiled_regime", "rmma", "rows"):
                got_f = quantized_matmul(x, q, s, out_dtype=odt, layer=1)
            torch.cuda.synchronize()
            ok_f, err_f, _ = _matmul_rule(torch, got_f, want, odt)
            print(f"[kernels] quantized_matmul {tag} (rows, forced): "
                  f"max|err| {err_f:.3e}", flush=True)
            require(bool(torch.isfinite(got_f).all()) and ok_f,
                    f"quantized_matmul {tag} (rows) disagrees: {err_f}")
        if tag not in timed:
            continue
        es = x.element_size()
        nbytes = (m * k * es + k * n + groups * n * 4
                  + m * n * got.element_size())
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, dname(torch, xdt))
        if m <= 8:
            qt, st = _int8pack(torch, q[1], s[1], xdt)
            lib_name = LIBRARY["quantized_matmul"]

            def library():
                return torch._weight_int8pack_mm(x, qt, st)
        else:
            wb = (q[1].to(xdt) * s[1].to(xdt))
            lib_name = "torch.matmul on the bf16 weight"

            def library():
                return torch.matmul(x, wb)
        r = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: quantized_matmul(
                x, q, s, out_dtype=odt, layer=1)),
            plain_ms=time_ms(torch, lambda: quantized_matmul_ref(
                x, q, s, out_dtype=odt, layer=1), iters=5),
            library_ms=time_ms(torch, library),
            bound_ms=bms, bound_by=by, library=lib_name, regime=regime)
        name = {"mma": "quantized_matmul_mma",
                "rmma": "quantized_matmul_rows_mma"}.get(regime,
                                                         "quantized_matmul")
        if regime == "rmma":
            _time_rows_mma(torch, gen, dev, mm, tag, (m, k, n, odt), x, q, s,
                           r, err_f, results, extra)
        extra.append((name, tag, r))
        results.setdefault(name, r)


def _time_rows_mma(torch, gen, dev, mm, tag, shape, x, q, s, r, err_f,
                   results, extra):
    """5r's case beside the FMA kernel it replaces (forced, same inputs),
    both also over weight copies past the L2; at the 7B wo, its time at
    each cap of the K split (ROWS_MMA_MAX_SPLIT, the reason for its
    value)."""
    from simplellminference_tpu_torch.ops.matmul import quantized_matmul
    m, k, n, odt = shape
    copies = max(2, int(2 * L2_BYTES // (k * n)) + 1)
    qr, sr = _qweight(torch, gen, dev, (copies, k, n), 1)

    def call(layer, q=q, s=s):
        return quantized_matmul(x, q, s, out_dtype=odt, layer=layer)

    def cold(layer):
        return call(layer, qr, sr)
    r["cold_ms"] = time_ms(torch, _rotating(cold, copies))
    with _Forced(mm, "tiled_regime", "rmma", "rows"):
        fma = dict(r, max_abs_err=err_f, regime="rows (forced)",
                   ms=time_ms(torch, lambda: call(1)),
                   cold_ms=time_ms(torch, _rotating(cold, copies)))
    print(f"[kernels] quantized_matmul {tag}: rmma {r['ms']:.6g} ms, "
          f"{r['cold_ms']:.6g} over {copies} weight copies "
          f"({copies * k * n / 1e6:.1f} MB, past the L2); the FMA kernel "
          f"(rows, forced) {fma['ms']:.6g}, {fma['cold_ms']:.6g}; bound "
          f"{r['bound_ms']:.6g}; library {r['library_ms']:.6g}", flush=True)
    extra.append(("quantized_matmul", tag + ", rows forced", fma))
    results.setdefault("quantized_matmul", fma)
    if tag != "llama2-7b wo decode":
        return
    cap0, min0 = mm.ROWS_MMA_MAX_SPLIT, mm.ROWS_MMA_MIN_K
    try:
        for cap, min_k in ((4, 256), (8, 256), (16, 256), (32, 128)):
            mm.ROWS_MMA_MAX_SPLIT, mm.ROWS_MMA_MIN_K = cap, min_k
            print(f"[kernels] quantized_matmul {tag} rmma, K split cap "
                  f"{cap} (min {min_k} rows: {mm.rows_mma_split(m, k, n)} "
                  f"rows a block): {time_ms(torch, lambda: call(1)):.6g} "
                  f"ms, {time_ms(torch, _rotating(cold, copies)):.6g} over "
                  f"the copies", flush=True)
    finally:
        mm.ROWS_MMA_MAX_SPLIT, mm.ROWS_MMA_MIN_K = cap0, min0


def _time_qkv(torch, form, tag, call, plain, q_ref, nbytes, ops, dtype,
              lib_w, results, extra, err, cold=None):
    """Times a fused qkv case on the tensor-core regime (6m: the wrapper,
    as the path calls it) and, forced on the same inputs, on the FMA kernel
    it replaces (whose q is held to the plain version's by the case's
    rule first), beside the plain version, the library call on the qkv
    product alone and, with ``cold`` (``call`` over weight copies past the
    L2), both again. The form's row takes the FMA kernel's first case,
    ``fused_qkv_append_mma`` 6m's first."""
    from simplellminference_tpu_torch.ops import qkv_fused as qf
    bms, by = bound_ms(nbytes, ops, dtype)
    x, qt, st = lib_w
    r = dict(max_abs_err=err, ms=time_ms(torch, call),
             plain_ms=time_ms(torch, plain),
             library_ms=time_ms(torch, lambda: torch._weight_int8pack_mm(
                 x, qt, st)),
             bound_ms=bms, bound_by=by, regime="mma")
    if cold is not None:
        r["cold_ms"] = time_ms(torch, cold)
    with _Forced(qf, "qkv_regime", "mma", "fma"):
        q_f = call()[0]
        torch.cuda.synchronize()
        err_f = max_err(q_f, q_ref)
        lim = TOL["bfloat16"] * float(q_ref.float().std())
        require(bool(torch.isfinite(q_f).all()) and err_f <= lim,
                f"{form} {tag} (fma, forced) disagrees: {err_f}")
        fma = dict(r, max_abs_err=err_f, regime="fma (forced)",
                   ms=time_ms(torch, call))
        if cold is not None:
            fma["cold_ms"] = time_ms(torch, cold)
    cold_txt = ("" if cold is None else f" ({r['cold_ms']:.6g} and "
                f"{fma['cold_ms']:.6g} over weight copies past the L2)")
    print(f"[kernels] {form} {tag}: 6m (mma) {r['ms']:.6g} ms, the FMA "
          f"kernel (forced) {fma['ms']:.6g}{cold_txt}; bound "
          f"{bms:.6g}; library {r['library_ms']:.6g}; plain "
          f"{r['plain_ms']:.6g}", flush=True)
    extra.append(("fused_qkv_append_mma", f"{form} {tag}", r))
    extra.append((form, f"{tag}, fma forced", fma))
    results.setdefault("fused_qkv_append_mma", r)
    results.setdefault(form, fma)


def _qkv_nbytes(h, nq, b, n, kvn, d, xes, nwes, kv_row, extra=0):
    """Bytes a fused qkv call must move: the weight and its scales, x, the
    norm weight, sin/cos, q out, the k/v rows (``kv_row`` bytes each) and
    the tables or positions (``extra``)."""
    return (h * nq + nq * 4 + b * h * xes + h * nwes + 2 * b * (d // 2) * 4
            + b * n * d * xes + 2 * b * kvn * kv_row + extra)


def check_fused_qkv(torch, dev, results, extra):
    from simplellminference_tpu_torch.ops import qkv_fused as qf
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.qkv_fused import (
        fused_qkv_append, fused_qkv_append_ref)
    gen = torch.Generator(device=dev).manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (b, h, n, kvn, d, activation dtype, pool dtype, unmapped row);
    # every bf16 case is timed on 6m and on the FMA kernel, the first also
    # over weight copies past the L2
    cases = {
        "llama2-7b": (8, 4096, 32, 32, 128, bf, bf, False),
        "llama2-7b unmapped row": (8, 4096, 32, 32, 128, bf, bf, True),
        "llama2-7b m1": (1, 4096, 32, 32, 128, bf, bf, False),
        "llama2-7b m64": (64, 4096, 32, 32, 128, bf, bf, True),
        "tinyllama-gqa f32": (8, 2048, 32, 4, 64, f32, f32, True),
        "tinyllama-gqa bf16": (5, 2048, 32, 4, 64, bf, bf, False),
    }
    for tag, (b, h, n, kvn, d, xdt, pdt, unmapped) in cases.items():
        ps, mp, layer = 128, 3, 1
        nq = (n + 2 * kvn) * d
        wq, ws = _qweight(torch, gen, dev, (2, h, nq), 1)
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(xdt)
        x = torch.randn((b, h), generator=gen, device=dev).to(xdt)
        pk, pv = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, pdt)
        tables = _tables(torch, dev, b, mp, dead_last=False)
        pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
        if unmapped:
            # the last row's page unmapped: its write goes to the trash
            tables[-1, int(pos[-1]) // ps] = -1
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
        qa, *_ = fused_qkv_append(x, nw, wq, ws, sin, cos, *a, layer, pos,
                                  n_heads=n, kv_heads=kvn, tables=tables)
        qr, *_ = fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, layer,
                                      pos, n_heads=n, kv_heads=kvn,
                                      tables=tables)
        torch.cuda.synchronize()
        page = tables.long()[torch.arange(b, device=dev), pos.long() // ps]
        page = torch.where(page >= 0, page, pk.shape[1] - 1)
        written = torch.zeros(pk.shape, dtype=torch.bool, device=dev)
        written[layer, page, :, pos.long() % ps] = True
        err = max_err(qa, qr)
        kv_err = max(max_err(ta[written], tr[written])
                     for ta, tr in zip(a, r))
        untouched = all(torch.equal(ta[~written], tr[~written])
                        for ta, tr in zip(a, r))
        if xdt == torch.float32:
            lim_q = F32_REL * float(qr.abs().max())
            lim_kv = F32_REL * max(float(tr[written].abs().max())
                                   for tr in r)
        else:
            lim_q = TOL["bfloat16"] * float(qr.float().std())
            lim_kv = TOL["bfloat16"] * max(float(tr[written].float().std())
                                           for tr in r)
        regime = qf.qkv_regime(b, h, nq, d, xdt)
        print(f"[kernels] fused_qkv_append {tag} ({regime}): q max|err| "
              f"{err:.3e} (tol {lim_q:.3e}); k/v rows {kv_err:.3e} (tol "
              f"{lim_kv:.3e}); other pool entries equal: {untouched}",
              flush=True)
        require(bool(torch.isfinite(qa).all()) and err <= lim_q
                and kv_err <= lim_kv and untouched,
                f"fused_qkv_append {tag} disagrees: {err}, {kv_err}, "
                f"{untouched}")
        if regime != "mma":
            continue
        nbytes = _qkv_nbytes(h, nq, b, n, kvn, d, x.element_size(),
                             nw.element_size(), d * pk.element_size(),
                             tables.numel() * 4 + b * 4)
        qt, st = _int8pack(torch, wq[layer], ws[layer], xdt)
        cold = None
        copies = max(2, int(2 * L2_BYTES // (h * nq)) + 1)
        if tag == "llama2-7b" and copies <= pk.shape[0]:
            wc, sc = _qweight(torch, gen, dev, (copies, h, nq), 1)
            nwc = nw[layer].expand(copies, h).contiguous()
            cold = _rotating(lambda li: fused_qkv_append(
                x, nwc, wc, sc, sin, cos, *a, li, pos, n_heads=n,
                kv_heads=kvn, tables=tables), copies)
        _time_qkv(torch, "fused_qkv_append", tag,
                  lambda: fused_qkv_append(
                      x, nw, wq, ws, sin, cos, *a, layer, pos, n_heads=n,
                      kv_heads=kvn, tables=tables),
                  lambda: fused_qkv_append_ref(
                      x, nw, wq, ws, sin, cos, *r, layer, pos, n_heads=n,
                      kv_heads=kvn, tables=tables),
                  qr, nbytes, 2.0 * b * h * nq, dname(torch, xdt),
                  (x, qt, st), results, extra, max(err, kv_err), cold)


def check_fused_ffn(torch, dev, results, extra):
    from simplellminference_tpu_torch.ops import ffn_fused as ff
    from simplellminference_tpu_torch.ops.ffn_fused import (fused_ffn,
                                                            fused_ffn_ref)
    gen = torch.Generator(device=dev).manual_seed(7)
    bf, f32 = torch.bfloat16, torch.float32
    # timed (the "llama2-7b" tags): the decode row, a spec_int8kv verify
    # step's 8 x 5 rows, the most rows the kernel takes (64), on the
    # tensor-core regime (fused_ffn_mma), and the decode row with f32
    # activations, the FMA kernels' row (phase 5's f32 paths run them)
    cases = {"llama2-7b": (8, 4096, 11008, bf, True),
             "llama2-7b verify m40": (40, 4096, 11008, bf, True),
             "llama2-7b m64": (64, 4096, 11008, bf, True),
             "llama2-7b f32": (8, 4096, 11008, f32, True),
             "llama2-7b m1": (1, 4096, 11008, bf, False),
             "llama2-7b m9": (9, 4096, 11008, bf, False),
             "mistral-7b": (4, 4096, 14336, bf, False),
             "tinyllama f32": (3, 2048, 5632, f32, False),
             "tinyllama m40": (40, 2048, 5632, bf, False)}
    regime_of = getattr(ff, "ffn_regime", lambda *a: "fma")
    for tag, (m, h, inter, xdt, timed) in cases.items():
        layer = 1
        q1, s1 = _qweight(torch, gen, dev, (2, h, 2 * inter), 1)
        q2, s2 = _qweight(torch, gen, dev, (2, inter, h), 1)
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(xdt)
        x = torch.randn((m, h), generator=gen, device=dev).to(xdt)
        got = fused_ffn(x, nw, q1, s1, q2, s2, layer)
        want = fused_ffn_ref(x, nw, q1, s1, q2, s2, layer)
        torch.cuda.synchronize()
        err = max_err(got, want)
        lim = (F32_REL * float(want.abs().max()) if xdt == torch.float32
               else TOL["bfloat16"] * float(want.float().std()))
        regime = regime_of(m, h, inter, xdt)
        print(f"[kernels] fused_ffn {tag} (m={m}, {regime}): max|err| "
              f"{err:.3e} (tol {lim:.3e})", flush=True)
        require(bool(torch.isfinite(got).all()) and err <= lim,
                f"fused_ffn {tag} disagrees: {err}")
        if not timed:
            continue
        es = x.element_size()
        nbytes = (3 * h * inter + (2 * inter + h) * 4 + 2 * m * h * es
                  + h * nw.element_size())
        bms, by = bound_ms(nbytes, 6.0 * m * h * inter, dname(torch, xdt))
        q1t, s1t = _int8pack(torch, q1[layer], s1[layer], xdt)
        q2t, s2t = _int8pack(torch, q2[layer], s2[layer], xdt)
        hx = torch.randn((m, inter), generator=gen, device=dev).to(xdt)
        r = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: fused_ffn(x, nw, q1, s1, q2, s2,
                                                layer)),
            plain_ms=time_ms(torch, lambda: fused_ffn_ref(
                x, nw, q1, s1, q2, s2, layer)),
            library_ms=time_ms(torch, lambda: (
                torch._weight_int8pack_mm(x, q1t, s1t),
                torch._weight_int8pack_mm(hx, q2t, s2t))),
            bound_ms=bms, bound_by=by, regime=regime)
        if regime == "mma":
            print_kernel_split(torch, f"fused_ffn {tag}", lambda: fused_ffn(
                x, nw, q1, s1, q2, s2, layer))
        name = "fused_ffn" + "_mma" * (regime == "mma")
        extra.append((name, tag, r))
        results.setdefault(name, r)


def print_kernel_split(torch, tag: str, fn, calls: int = 20) -> None:
    """Device time of each CUDA kernel one call of ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls (the 7m FFN's three launches,
    or every kernel of a decode step: where its time goes)."""
    import re

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+(<[^(]*>)?)\(", e.key)
            parts.append(f"{name.group(1) if name else e.key[:40]} "
                         f"{e.device_time_total / calls / 1e3:.6g} ms")
    print(f"[kernels] {tag} by kernel (torch.profiler, a call): "
          f"{'; '.join(parts) or 'no device time recorded'}", flush=True)


def check_paged_prefill(torch, dev, results, extra):
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops.attention.paged_prefill import (
        paged_flash_prefill, paged_flash_prefill_ref)
    gen = torch.Generator(device=dev).manual_seed(8)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (sq, n, kvn, d, ps, offsets, kv_lens, dtype, unmapped entries);
    # the first two are the `prefix` path's dispatches (a suffix batch of
    # 8 x 64 rows behind a 512-token prefix, one 256-row chunk), timed;
    # the first is the row. The GQA case has ragged offsets, an unmapped
    # page inside kv_len and a batch's padding row (-1 table, kv_len 1).
    cases = {
        "llama2-7b suffix batch": (64, 32, 32, 128, 128, [512] * 8,
                                   [540 + 5 * i for i in range(8)], bf,
                                   False),
        "llama2-7b chunk": (256, 32, 32, 128, 128, [512], [576], bf, False),
        "tinyllama-gqa f32": (100, 32, 4, 64, 16, [0, 48, 16, 0],
                              [100, 130, 77, 1], f32, True),
    }
    timed = list(cases)[:2]
    for tag, (sq, n, kvn, d, ps, offs, lens, dtype, unmapped) in \
            cases.items():
        b = len(offs)
        mp = -(-max(o + sq for o in offs) // ps)
        pk, pv = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, dtype)
        tables = _tables(torch, dev, b, mp, dead_last=unmapped)
        if unmapped:
            tables[2, 1] = -1           # inside row 2's kv_len
        q = torch.randn((b, sq, n, d), generator=gen, device=dev,
                        dtype=dtype)
        off_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        kv_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        layer = 1
        got = paged_flash_prefill(q, pk, pv, tables, kv_t, off_t, layer)
        want = paged_flash_prefill_ref(q, pk, pv, tables, kv_t, off_t, layer)
        torch.cuda.synchronize()
        ok, err, note = _prefill_rule(torch, got, want)
        print(f"[kernels] paged_flash_prefill {tag} (B={b} Sq={sq} N={n} "
              f"kvN={kvn} D={d} ps={ps}): max|err| {err:.3e} ({note}); "
              f"every row finite: {bool(torch.isfinite(got).all())}",
              flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"paged_flash_prefill {tag} disagrees: {err} ({note})")
        if tag not in timed:
            continue
        # what these inputs need: each row's keys below min(kv_len, its
        # position + 1); K/V rows up to each sequence's frontier
        es = q.element_size()
        keys = sum(min(o + r + 1, ln) for o, ln in zip(offs, lens)
                   for r in range(sq))
        kv_rows = sum(min(ln, o + sq) for o, ln in zip(offs, lens))
        nbytes = (2 * b * sq * n * d * es + 2 * kv_rows * kvn * d * es
                  + tables.numel() * 4 + 2 * b * 4)
        bms, by = bound_ms(nbytes, 4.0 * n * d * keys, dname(torch, dtype))
        ck, cv = gather_dense(pk[layer], pv[layer], tables)
        key_pos = torch.arange(ck.shape[2], device=dev)
        q_pos = off_t.long()[:, None] + torch.arange(sq, device=dev)[None]
        mask = ((key_pos[None, None] <= q_pos[:, :, None])
                & (key_pos[None, None] < kv_t.long()[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        r = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: paged_flash_prefill(
                q, pk, pv, tables, kv_t, off_t, layer)),
            plain_ms=time_ms(torch, lambda: paged_flash_prefill_ref(
                q, pk, pv, tables, kv_t, off_t, layer)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, ck, cv, attn_mask=mask)),
            bound_ms=bms, bound_by=by)
        extra.append(("paged_flash_prefill", tag, r))
        if "paged_flash_prefill" not in results:
            results["paged_flash_prefill"] = r


def _quant_pools(torch, gen, dev, layers, pages, kvn, ps, d):
    """INT8 pools as the Engine fills them: N(0, 1) K/V rows (kernel 4's
    and 8's pools) quantized per (token, head) by the plain quantize_kv."""
    from simplellminference_tpu_torch.memory.paged_kv import quantize_kv
    shape = (layers, pages + 1, kvn, ps, d)
    qk, sk = quantize_kv(torch.randn(shape, generator=gen, device=dev))
    qv, sv = quantize_kv(torch.randn(shape, generator=gen, device=dev))
    return qk, qv, sk, sv


def _quantize_lib(torch, x):
    """quantize_kv in plain torch operations (the library yardstick)."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    s = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-8)
    return torch.round(xf / s[..., None]).clamp_(-127, 127).to(
        torch.int8), s


def check_append_decode_quant(torch, dev, results):
    from simplellminference_tpu_torch.ops.paged_append import (
        paged_append_decode_quant, paged_append_decode_quant_ref)
    gen = torch.Generator(device=dev).manual_seed(11)
    main = None
    for tag, (b, kvn, d, dtype) in {
            "llama2-7b": (8, 32, 128, torch.bfloat16),
            "gqa": (8, 4, 64, torch.float32)}.items():
        ps, mp, layer = 128, 3, 1
        pools = _quant_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        qkv = torch.randn((b, 3 * kvn * d), generator=gen, device=dev,
                          dtype=dtype) * 4
        nk = qkv[:, kvn * d:2 * kvn * d].reshape(b, kvn, d)
        nv = qkv[:, 2 * kvn * d:].reshape(b, kvn, d)   # strided, like the model
        tables = _tables(torch, dev, b, mp)
        pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
        a, r = [p.clone() for p in pools], [p.clone() for p in pools]
        paged_append_decode_quant(*a, nk, nv, tables, pos, layer)
        paged_append_decode_quant_ref(*r, nk, nv, tables, pos, layer)
        torch.cuda.synchronize()
        err = max(max_err(x[:, :-1], y[:, :-1]) for x, y in zip(a, r))
        print(f"[kernels] paged_append_decode_quant {tag}: codes and scales "
              f"max|err| {err} (tol 0, byte-equal; trash page excluded)",
              flush=True)
        require(err == 0.0, f"paged_append_decode_quant {tag} disagrees: "
                f"{err}")
        if main is None:
            p1 = pools[0].shape[1]
            page = tables.long().gather(1, (pos.long() // ps)[:, None])[:, 0]
            page = torch.where(page >= 0, page, p1 - 1)
            slot = pos.long() % ps
            heads = torch.arange(kvn, device=dev)
            ix = (page[:, None], heads[None], slot[:, None])

            def library():
                for pool, sc, x in ((a[0], a[2], nk), (a[1], a[3], nv)):
                    q, s = _quantize_lib(torch, x)
                    pool[layer].index_put_(ix, q)
                    sc[layer].index_put_(ix, s)

            es = nk.element_size()
            nbytes = (2 * b * kvn * d * es + 2 * b * kvn * (d + 4)
                      + tables.numel() * 4 + pos.numel() * 4)
            bms, by = bound_ms(nbytes, 0.0, dname(torch, dtype))
            main = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: paged_append_decode_quant(
                    *a, nk, nv, tables, pos, layer)),
                plain_ms=time_ms(torch, lambda: paged_append_decode_quant_ref(
                    *r, nk, nv, tables, pos, layer)),
                library_ms=time_ms(torch, library),
                bound_ms=bms, bound_by=by)
    results["paged_append_decode_quant"] = main


def check_append_prefill_quant(torch, dev, results):
    from simplellminference_tpu_torch.ops.paged_append import (
        paged_append_prefill_quant, paged_append_prefill_quant_ref)
    gen = torch.Generator(device=dev).manual_seed(12)
    main = None
    for tag, (b, s, kvn, d, dtype) in {
            "llama2-7b": (8, 128, 32, 128, torch.bfloat16),
            "ragged": (8, 100, 32, 128, torch.bfloat16),
            "gqa": (4, 300, 4, 64, torch.float32)}.items():
        ps, mp, layer = 128, 3, 0
        pools = _quant_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        qkv = torch.randn((b, s, 3 * kvn * d), generator=gen, device=dev,
                          dtype=dtype) * 4
        nk = qkv[..., kvn * d:2 * kvn * d].reshape(b, s, kvn, d)
        nv = qkv[..., 2 * kvn * d:].reshape(b, s, kvn, d)   # strided views
        tables = _tables(torch, dev, b, mp)
        a, r = [p.clone() for p in pools], [p.clone() for p in pools]
        paged_append_prefill_quant(*a, nk, nv, tables, layer)
        paged_append_prefill_quant_ref(*r, nk, nv, tables, layer)
        torch.cuda.synchronize()
        err = max(max_err(x[:, :-1], y[:, :-1]) for x, y in zip(a, r))
        print(f"[kernels] paged_append_prefill_quant {tag}: codes and scales "
              f"max|err| {err} (tol 0, byte-equal; trash page excluded)",
              flush=True)
        require(err == 0.0, f"paged_append_prefill_quant {tag} disagrees: "
                f"{err}")
        if main is None:
            npg = -(-s // ps)
            p1 = pools[0].shape[1]
            idx = tables[:, :npg].long()
            idx = torch.where(idx >= 0, idx, p1 - 1).reshape(-1)

            def library():
                for pool, sc, x in ((a[0], a[2], nk), (a[1], a[3], nv)):
                    q, sq = _quantize_lib(torch, x)
                    pool[layer].index_copy_(0, idx, q.reshape(
                        b, npg, ps, kvn, d).transpose(2, 3).reshape(
                            b * npg, kvn, ps, d))
                    sc[layer].index_copy_(0, idx, sq.reshape(
                        b, npg, ps, kvn).transpose(2, 3).reshape(
                            b * npg, kvn, ps))

            es = nk.element_size()
            nbytes = (2 * b * s * kvn * d * es
                      + 2 * b * npg * ps * kvn * (d + 4) + b * mp * 4)
            bms, by = bound_ms(nbytes, 0.0, dname(torch, dtype))
            main = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: paged_append_prefill_quant(
                    *a, nk, nv, tables, layer)),
                plain_ms=time_ms(torch, lambda: paged_append_prefill_quant_ref(
                    *r, nk, nv, tables, layer)),
                library_ms=time_ms(torch, library),
                bound_ms=bms, bound_by=by)
    results["paged_append_prefill_quant"] = main


def _dequant_sdpa(torch, q4, pk, pv, ks, vs, tables, layer, mask):
    """The library yardstick of the INT8-KV attention forms: gather and
    dequantize in f32 (torch operations), cast to q's dtype, then
    scaled_dot_product_attention."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    ck, cv = gather_dense(pk[layer], pv[layer], tables, ks[layer], vs[layer])
    return F.scaled_dot_product_attention(q4, ck.to(q4.dtype),
                                          cv.to(q4.dtype), attn_mask=mask)


def check_paged_decode_int8kv(torch, dev, results, extra):
    """Form 4q against its plain version by the rounding rule, at kernel
    4's cases: the bench shape (the row), GQA with a dead slot, the split
    edges and the long step's shape (B 8, kv_len 4096; timed)."""
    from simplellminference_tpu_torch.ops.attention.paged_decode import (
        paged_flash_decode_int8kv, paged_flash_decode_ref)
    gen = torch.Generator(device=dev).manual_seed(13)
    bf, f32 = torch.bfloat16, torch.float32
    cases = {
        "llama2-7b": (32, 32, 128, bf, [128 + 4 * i for i in range(8)], 2,
                      False),
        "gqa-f32": (32, 4, 64, f32, [1, 5, 128, 200, 0, 129], 2, True),
        "gqa-bf16": (32, 4, 64, bf, [1, 5, 128, 200, 0, 129], 2, True),
        "llama2-7b kv_len 4096": (32, 32, 128, bf, [4096] * 8, 32, False),
    }
    for i, lens in enumerate(_split_edge_lens(32, 2048)):
        cases[f"split edges mha-bf16 {i}"] = (32, 32, 128, bf, lens, 16, True)
    for i, lens in enumerate(_split_edge_lens(4, 2048, rows=8)):
        cases[f"split edges gqa-f32 {i}"] = (32, 4, 64, f32, lens, 16, True)
    timed = ("llama2-7b", "llama2-7b kv_len 4096")
    for tag, (n, kvn, d, dtype, lens, mp, dead) in cases.items():
        b, ps, layer = len(lens), 128, 1
        pk, pv, ks, vs = _quant_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        q = torch.randn((b, n, d), generator=gen, device=dev, dtype=dtype)
        tables = _tables(torch, dev, b, mp, dead_last=dead)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = paged_flash_decode_int8kv(q, pk, pv, ks, vs, tables, kv_lens,
                                        layer)
        want = paged_flash_decode_ref(q, pk, pv, tables, kv_lens, layer,
                                      k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        zero = [i for i in range(b) if lens[i] == 0] + [b - 1] * dead
        err = _attn_check(torch, "paged_flash_decode_int8kv", tag, got, want,
                          zero)
        if tag not in timed:
            continue
        mask = (torch.arange(mp * ps, device=dev)[None, None, None, :]
                < kv_lens.long()[:, None, None, None])
        es = q.element_size()
        # q in, out; each live key's int8 K and V rows and two scales
        kvb, live = _decode_bytes(torch, tables, kv_lens, ps,
                                  kvn * 2 * (d + 4))
        nbytes = 2 * b * n * d * es + kvb + tables.numel() * 4 + b * 4
        bms, by = bound_ms(nbytes, 4.0 * n * d * live, dname(torch, dtype))
        q4 = q[:, :, None]
        res = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: paged_flash_decode_int8kv(
                q, pk, pv, ks, vs, tables, kv_lens, layer)),
            plain_ms=time_ms(torch, lambda: paged_flash_decode_ref(
                q, pk, pv, tables, kv_lens, layer, k_scale=ks,
                v_scale=vs)),
            library_ms=time_ms(torch, lambda: _dequant_sdpa(
                torch, q4, pk, pv, ks, vs, tables, layer, mask)),
            bound_ms=bms, bound_by=by)
        extra.append(("paged_flash_decode_int8kv", tag, res))
        results.setdefault("paged_flash_decode_int8kv", res)


def check_paged_prefill_int8kv(torch, dev, results, extra):
    from simplellminference_tpu_torch.ops.attention.paged_prefill import (
        paged_flash_prefill_int8kv, paged_flash_prefill_ref)
    gen = torch.Generator(device=dev).manual_seed(14)
    bf, f32 = torch.bfloat16, torch.float32
    # kernel 8's cases over INT8 pools: the suffix batch and the chunk of
    # the prefix paths (timed; the first is the row) and a GQA case with
    # ragged offsets, an unmapped page inside kv_len and a padding row
    cases = {
        "llama2-7b suffix batch": (64, 32, 32, 128, 128, [512] * 8,
                                   [540 + 5 * i for i in range(8)], bf,
                                   False),
        "llama2-7b chunk": (256, 32, 32, 128, 128, [512], [576], bf, False),
        "tinyllama-gqa f32": (100, 32, 4, 64, 16, [0, 48, 16, 0],
                              [100, 130, 77, 1], f32, True),
    }
    timed = list(cases)[:2]
    for tag, (sq, n, kvn, d, ps, offs, lens, dtype, unmapped) in \
            cases.items():
        b = len(offs)
        mp = -(-max(o + sq for o in offs) // ps)
        pk, pv, ks, vs = _quant_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        tables = _tables(torch, dev, b, mp, dead_last=unmapped)
        if unmapped:
            tables[2, 1] = -1           # inside row 2's kv_len
        q = torch.randn((b, sq, n, d), generator=gen, device=dev,
                        dtype=dtype)
        off_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        kv_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        layer = 1
        got = paged_flash_prefill_int8kv(q, pk, pv, ks, vs, tables, kv_t,
                                         off_t, layer)
        want = paged_flash_prefill_ref(q, pk, pv, tables, kv_t, off_t, layer,
                                       k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        ok, err, note = _prefill_rule(torch, got, want)
        print(f"[kernels] paged_flash_prefill_int8kv {tag} (B={b} Sq={sq} "
              f"N={n} kvN={kvn} D={d} ps={ps}): max|err| {err:.3e} ({note}); "
              f"every row finite: {bool(torch.isfinite(got).all())}",
              flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"paged_flash_prefill_int8kv {tag} disagrees: {err} ({note})")
        if tag not in timed:
            continue
        es = q.element_size()
        keys = sum(min(o + r + 1, ln) for o, ln in zip(offs, lens)
                   for r in range(sq))
        kv_rows = sum(min(ln, o + sq) for o, ln in zip(offs, lens))
        nbytes = (2 * b * sq * n * d * es + kv_rows * kvn * 2 * (d + 4)
                  + tables.numel() * 4 + 2 * b * 4)
        bms, by = bound_ms(nbytes, 4.0 * n * d * keys, dname(torch, dtype))
        key_pos = torch.arange(mp * ps, device=dev)
        q_pos = off_t.long()[:, None] + torch.arange(sq, device=dev)[None]
        mask = ((key_pos[None, None] <= q_pos[:, :, None])
                & (key_pos[None, None] < kv_t.long()[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        r = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: paged_flash_prefill_int8kv(
                q, pk, pv, ks, vs, tables, kv_t, off_t, layer)),
            plain_ms=time_ms(torch, lambda: paged_flash_prefill_ref(
                q, pk, pv, tables, kv_t, off_t, layer, k_scale=ks,
                v_scale=vs)),
            library_ms=time_ms(torch, lambda: _dequant_sdpa(
                torch, qt, pk, pv, ks, vs, tables, layer, mask)),
            bound_ms=bms, bound_by=by)
        extra.append(("paged_flash_prefill_int8kv", tag, r))
        if "paged_flash_prefill_int8kv" not in results:
            results["paged_flash_prefill_int8kv"] = r


def check_fused_qkv_int8kv(torch, dev, results, extra):
    from simplellminference_tpu_torch.ops import qkv_fused as qf
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.qkv_fused import (
        fused_qkv_append_int8kv, fused_qkv_append_ref)
    gen = torch.Generator(device=dev).manual_seed(15)
    bf, f32 = torch.bfloat16, torch.float32
    # every bf16 case is timed on 6m and on the FMA kernel
    cases = {
        "llama2-7b": (8, 4096, 32, 32, 128, bf, False),
        "llama2-7b unmapped row": (8, 4096, 32, 32, 128, bf, True),
        "llama2-7b m1": (1, 4096, 32, 32, 128, bf, False),
        "llama2-7b m64": (64, 4096, 32, 32, 128, bf, True),
        "tinyllama-gqa f32": (8, 2048, 32, 4, 64, f32, True),
        "tinyllama-gqa bf16": (5, 2048, 32, 4, 64, bf, False),
    }
    for tag, (b, h, n, kvn, d, xdt, unmapped) in cases.items():
        ps, mp, layer = 128, 3, 1
        nq = (n + 2 * kvn) * d
        wq, ws = _qweight(torch, gen, dev, (2, h, nq), 1)
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(xdt)
        x = torch.randn((b, h), generator=gen, device=dev).to(xdt)
        pools = _quant_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        tables = _tables(torch, dev, b, mp, dead_last=False)
        pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
        if unmapped:
            # the last row's page unmapped: its write goes to the trash
            tables[-1, int(pos[-1]) // ps] = -1
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        a, r = [p.clone() for p in pools], [p.clone() for p in pools]
        qa, *_ = fused_qkv_append_int8kv(x, nw, wq, ws, sin, cos, *a, layer,
                                         pos, n_heads=n, kv_heads=kvn,
                                         tables=tables)
        qr, *_ = fused_qkv_append_ref(x, nw, wq, ws, sin, cos, r[0], r[1],
                                      layer, pos, n_heads=n, kv_heads=kvn,
                                      tables=tables, cache_ks=r[2],
                                      cache_vs=r[3])
        torch.cuda.synchronize()
        page = tables.long()[torch.arange(b, device=dev), pos.long() // ps]
        page = torch.where(page >= 0, page, pools[0].shape[1] - 1)
        written = torch.zeros(pools[2].shape, dtype=torch.bool, device=dev)
        written[layer, page, :, pos.long() % ps] = True
        err = max_err(qa, qr)
        lim_q = (F32_REL * float(qr.abs().max()) if xdt == f32
                 else TOL["bfloat16"] * float(qr.float().std()))
        code_d = max(int((ta[written].int() - tr[written].int()).abs().max())
                     for ta, tr in zip(a[:2], r[:2]))
        share = sum(int((ta[written] != tr[written]).sum())
                    for ta, tr in zip(a[:2], r[:2])) / (
                        2 * int(written.sum()) * d)
        s_err = max(max_err(sa[written], sr[written])
                    for sa, sr in zip(a[2:], r[2:]))
        if xdt == f32:
            s_ok = all(bool(((sa[written] - sr[written]).abs()
                             <= F32_REL * sr[written]).all())
                       for sa, sr in zip(a[2:], r[2:]))
            s_rule = f"{F32_REL:g} relative"
        else:
            s_ok = all(bool(((sa[written] - sr[written]).abs()
                             <= _bf16_ulp(torch, sr[written] * 127.0)
                             / 127.0 * (1 + 1e-6)).all())
                       for sa, sr in zip(a[2:], r[2:]))
            s_rule = "one bf16 ulp of the absmax / 127"
        untouched = all(torch.equal(ta[~written], tr[~written])
                        for ta, tr in zip(a[:2], r[:2])) and all(
            torch.equal(sa[~written], sr[~written])
            for sa, sr in zip(a[2:], r[2:]))
        regime = qf.qkv_regime(b, h, nq, d, xdt)
        print(f"[kernels] fused_qkv_append_int8kv {tag} ({regime}): q "
              f"max|err| {err:.3e} (tol {lim_q:.3e}); k/v codes at most "
              f"{code_d} apart (tol 1), {share:.3e} of them differ; scales "
              f"max|err| {s_err:.3e} (tol {s_rule}): {s_ok}; other entries "
              f"equal: {untouched}", flush=True)
        require(bool(torch.isfinite(qa).all()) and err <= lim_q
                and code_d <= 1 and s_ok and untouched,
                f"fused_qkv_append_int8kv {tag} disagrees: {err}, {code_d}, "
                f"{s_ok}, {untouched}")
        if regime != "mma":
            continue
        nbytes = _qkv_nbytes(h, nq, b, n, kvn, d, x.element_size(),
                             nw.element_size(), d + 4,
                             tables.numel() * 4 + b * 4)
        qt, st = _int8pack(torch, wq[layer], ws[layer], xdt)
        _time_qkv(torch, "fused_qkv_append_int8kv", tag,
                  lambda: fused_qkv_append_int8kv(
                      x, nw, wq, ws, sin, cos, *a, layer, pos, n_heads=n,
                      kv_heads=kvn, tables=tables),
                  lambda: fused_qkv_append_ref(
                      x, nw, wq, ws, sin, cos, r[0], r[1], layer, pos,
                      n_heads=n, kv_heads=kvn, tables=tables, cache_ks=r[2],
                      cache_vs=r[3]),
                  qr, nbytes, 2.0 * b * h * nq, dname(torch, xdt),
                  (x, qt, st), results, extra,
                  max(err, float(code_d), s_err))


def _span_case(torch, gen, dev, b, t, kvn, d, dtype, pos0, quant=False):
    """Pools, strided new K/V [B, T, kvN, D], tables and positions of a
    span write: row 0 crosses a page boundary, the last row is a dead
    slot (all -1 table), the rest sit at pos0 + 4i."""
    ps, mp, layer = 128, 3, 1
    if quant:
        pools = _quant_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
    else:
        pools = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, dtype)
    qkv = torch.randn((b, t, 3 * kvn * d), generator=gen, device=dev,
                      dtype=dtype)
    nk = qkv[..., kvn * d:2 * kvn * d].reshape(b, t, kvn, d)
    nv = qkv[..., 2 * kvn * d:].reshape(b, t, kvn, d)  # strided, like the model
    tables = _tables(torch, dev, b, mp)
    pos = (pos0 + 4 * torch.arange(b, device=dev)).to(torch.int32)
    pos[0] = ps - 2
    return pools, nk, nv, tables, pos, layer


def check_append_span(torch, dev, results):
    from simplellminference_tpu_torch.ops.paged_append import (
        paged_append_span, paged_append_span_ref, span_slots)
    gen = torch.Generator(device=dev).manual_seed(16)
    main = None
    # the spec paths' call (8 rows x 5, 7B bf16) first, then a GQA f32
    # case with the longest span
    for tag, (b, t, kvn, d, dtype) in {
            "llama2-7b": (8, 5, 32, 128, torch.bfloat16),
            "gqa f32 span 8": (8, 8, 8, 128, torch.float32),
            "tinyllama span 2": (5, 2, 4, 64, torch.bfloat16)}.items():
        (pk, pv), nk, nv, tables, pos, layer = _span_case(
            torch, gen, dev, b, t, kvn, d, dtype, 150)
        ka, va, kb, vb = pk.clone(), pv.clone(), pk.clone(), pv.clone()
        paged_append_span(ka, va, nk, nv, tables, pos, layer)
        paged_append_span_ref(kb, vb, nk, nv, tables, pos, layer)
        torch.cuda.synchronize()
        err = max(max_err(ka[:, :-1], kb[:, :-1]),
                  max_err(va[:, :-1], vb[:, :-1]))
        print(f"[kernels] paged_append_span {tag} (B={b} T={t} kvN={kvn} "
              f"D={d}; a span across a page, a dead row): max|err| {err} "
              f"(tol 0, exact; trash page excluded)", flush=True)
        require(err == 0.0, f"paged_append_span {tag} disagrees: {err}")
        if main is not None:
            continue
        p1, ps = pk.shape[1], pk.shape[3]
        page, slot = span_slots(tables, pos, t, p1, ps)
        heads = torch.arange(kvn, device=dev)
        flat = ((page[:, :, None] * kvn + heads) * ps
                + slot[:, :, None]).reshape(-1)
        rows_k = nk.reshape(-1, d)
        rows_v = nv.reshape(-1, d)

        def library():
            ka[layer].view(-1, d).index_copy_(0, flat, rows_k)
            va[layer].view(-1, d).index_copy_(0, flat, rows_v)

        es = pk.element_size()
        nbytes = (2 * 2 * b * t * kvn * d * es + tables.numel() * 4
                  + pos.numel() * 4)
        bms, by = bound_ms(nbytes, 0.0, dname(torch, dtype))
        main = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: paged_append_span(
                ka, va, nk, nv, tables, pos, layer)),
            plain_ms=time_ms(torch, lambda: paged_append_span_ref(
                kb, vb, nk, nv, tables, pos, layer)),
            library_ms=time_ms(torch, library),
            bound_ms=bms, bound_by=by)
    results["paged_append_span"] = main


def check_paged_verify(torch, dev, results, extra, kv: str):
    """Kernel 4v (``kv`` "int8": 4vq; "fp8": 4ve) against its plain version
    by the rounding rule at S in {1, 2, 5, 8}, with GQA (N=32, kvN=8) and
    without (N=kvN=32), f32 and bf16, kv_len 0 and across a page; the split
    edges at S 5 (GQA bf16); timed at the spec paths' 8 x 5-row call (the
    row) and at long context (kv_len 4096)."""
    from simplellminference_tpu_torch.ops.attention.paged_decode import (
        paged_flash_verify, paged_flash_verify_fp8kv,
        paged_flash_verify_int8kv, paged_flash_verify_ref)
    quant, fp8 = kv == "int8", kv == "fp8"
    name = "paged_flash_verify" + {"bf16": "", "int8": "_int8kv",
                                   "fp8": "_fp8kv"}[kv]
    kern = {"bf16": paged_flash_verify, "int8": paged_flash_verify_int8kv,
            "fp8": paged_flash_verify_fp8kv}[kv]
    gen = torch.Generator(device=dev).manual_seed(17 + quant + 2 * fp8)
    bf = torch.bfloat16
    # tag: (S, n, kvn, dtype, lens, mp)
    cases = [("llama2-7b", 5, 32, 32, bf, [147 + 2 * i for i in range(8)],
              2)]
    cases += [(f"{'gqa' if kvn < n else 'mha'} S={s} {dname(torch, dt)}", s,
               n, kvn, dt, [s, 128, 129, 200, 0, 57 + s, 255, 130], 2)
              for s in (1, 2, 5, 8) for n, kvn in ((32, 8), (32, 32))
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(f"split edges gqa S=5 bfloat16 {i}", 5, 32, 8, bf, lens, 16)
              for i, lens in enumerate(
                  _split_edge_lens(8, 2048, wins=5, rows=20))]
    cases += [("llama2-7b kv_len 4096", 5, 32, 32, bf, [4096] * 8, 33)]
    timed = ("llama2-7b", "llama2-7b kv_len 4096")
    for tag, s, n, kvn, dtype, lens, mp in cases:
        b, d, ps, layer = len(lens), 128, 128, 1
        if quant:
            pools = _quant_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        elif fp8:
            pools = _e4m3_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        else:
            pools = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, dtype)
        pk, pv, *sc = pools
        q = torch.randn((b, s, n, d), generator=gen, device=dev, dtype=dtype)
        tables = _tables(torch, dev, b, mp, dead_last=False)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        scales = dict(k_scale=sc[0], v_scale=sc[1]) if quant else {}
        args = (q, pk, pv) + ((sc[0], sc[1]) if quant else ())
        got = kern(*args, tables, kv_lens, layer)
        want = paged_flash_verify_ref(q, pk, pv, tables, kv_lens, layer,
                                      **scales)
        torch.cuda.synchronize()
        err = _attn_check(torch, name, tag, got, want,
                          [i for i in range(b) if lens[i] == 0])
        if tag not in timed:
            continue
        # what these inputs need: row s of sequence i attends its keys at
        # positions <= kv_len - S + s; each sequence's K/V rows once
        keys = sum(max(0, ln - s + 1 + r) for ln in lens for r in range(s))
        es = q.element_size()
        per_key = 2 * (d + 4) if quant else 2 * d * pk.element_size()
        nbytes = (2 * b * s * n * d * es + sum(lens) * kvn * per_key
                  + tables.numel() * 4 + b * 4)
        bms, by = bound_ms(nbytes, 4.0 * n * d * keys, dname(torch, dtype))
        key_pos = torch.arange(tables.shape[1] * pk.shape[3], device=dev)
        q_pos = (kv_lens.long()[:, None] - s
                 + torch.arange(s, device=dev)[None])
        mask = (key_pos[None, None, None, :] <= q_pos[:, None, :, None])
        qt = q.transpose(1, 2)
        if quant:
            def library():
                return _dequant_sdpa(torch, qt, pk, pv, sc[0], sc[1], tables,
                                     layer, mask)
        elif fp8:
            def library():
                return _cast_sdpa(torch, qt, pk, pv, tables, layer, mask)
        else:
            import torch.nn.functional as F

            from simplellminference_tpu_torch.memory.paged_kv import (
                gather_dense)
            ck, cv = gather_dense(pk[layer], pv[layer], tables)

            def library():
                return F.scaled_dot_product_attention(qt, ck, cv,
                                                      attn_mask=mask)
        res = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: kern(*args, tables, kv_lens, layer)),
            plain_ms=time_ms(torch, lambda: paged_flash_verify_ref(
                q, pk, pv, tables, kv_lens, layer, **scales)),
            library_ms=time_ms(torch, library),
            bound_ms=bms, bound_by=by)
        extra.append((name, tag, res))
        results.setdefault(name, res)


# ------------------------------------------------- FP8 (e4m3) KV: 1e-8e

def _e4m3_pools(torch, gen, dev, layers, pages, kvn, ps, d):
    """e4m3 pools as the Engine fills them: N(0, 1) K/V rows (kernel 4's
    and 8's pools) cast by the plain to_e4m3."""
    from simplellminference_tpu_torch.ops.ref_ops import to_e4m3
    shape = (layers, pages + 1, kvn, ps, d)
    return tuple(to_e4m3(torch.randn(shape, generator=gen, device=dev))
                 for _ in range(2))


def _codes_err(torch, a, b) -> int:
    """Bytes apart between e4m3 pools (0: byte-equal)."""
    return int((a.view(torch.uint8) != b.view(torch.uint8)).sum())


def _cast_lib(torch, x):
    """The library yardstick of the FP8-KV writes: PyTorch's own cast, as
    uint8 codes (its overflow rule varies with the PyTorch version:
    saturating to +-448 in some, NaN past 464 as JAX's in others; phase 3
    prints this card's)."""
    return x.to(torch.float8_e4m3fn).view(torch.uint8)


def check_e4m3_conversion(torch, dev):
    """The card's e4m3 conversion (common.cuh f_to_e4m3, as forms 1e, 2e,
    11e and 6e store it) byte-equal to to_e4m3 computed on the host: every
    one of the 65,536 bf16 bit patterns through form 2e (bf16 rows), and
    the f32 edges (448, 464, just past 464, 480, inf, NaN, subnormals,
    -0, f32 subnormals, each signed) through form 1e (f32 rows)."""
    from simplellminference_tpu_torch.ops import paged_append as pa
    from simplellminference_tpu_torch.ops.ref_ops import to_e4m3
    e4 = torch.float8_e4m3fn
    pat = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    want = to_e4m3(pat).view(torch.uint8)
    rows = pat.reshape(1, 512, 1, 128).to(dev)
    pk = torch.zeros((1, 5, 1, 128, 128), dtype=e4, device=dev)
    pv = torch.zeros_like(pk)
    tables = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32, device=dev)
    pa.paged_append_prefill_fp8kv(pk, pv, rows, rows, tables, 0)
    got = pk[0, :4, 0].reshape(-1).view(torch.uint8).cpu()
    bf_apart = int((got != want).sum())
    edges = torch.tensor([448, 464, 464.00003, 480, 500, 1e4, float("inf"),
                          float("nan"), 0.0, 2.0 ** -9, 2.0 ** -10,
                          3 * 2.0 ** -10, 2.0 ** -6 * 0.99, 1e-40, 240, 232],
                         dtype=torch.float32)
    edges = torch.cat([edges, -edges])
    pk = torch.zeros((1, 2, 1, 8, 32), dtype=e4, device=dev)
    pv = torch.zeros_like(pk)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    pa.paged_append_decode_fp8kv(pk, pv, edges.reshape(1, 1, 32).to(dev),
                                 edges.reshape(1, 1, 32).to(dev),
                                 zero[:, None], zero, 0)
    f32_apart = int((pk[0, 0, 0, 0].view(torch.uint8).cpu()
                     != to_e4m3(edges).view(torch.uint8)).sum())
    lib_apart = int((_cast_lib(torch, pat).cpu() != want).sum())
    print(f"[kernels] e4m3 conversion on the card: {bf_apart} of 65536 bf16 "
          f"bit patterns and {f32_apart} of {edges.numel()} f32 edges apart "
          f"from to_e4m3 (tol 0); PyTorch {torch.__version__}'s own cast "
          f"gives {lib_apart} of the bf16 patterns apart", flush=True)
    require(bf_apart == 0 and f32_apart == 0,
            f"e4m3 conversion apart: {bf_apart} bf16, {f32_apart} f32")


def check_append_fp8kv(torch, dev, results):
    """Forms 1e, 2e and 11e byte-equal to their plain versions (trash page
    excluded) at the paths' shapes (7B bf16: decode 8 rows, prefill 8 x
    128 and ragged 100, span 8 x 5) and GQA f32 rows, the rows scaled so
    that some pass 464; the first case of each timed beside the byte
    bound and PyTorch's cast + indexed writes."""
    from simplellminference_tpu_torch.ops import paged_append as pa
    gen = torch.Generator(device=dev).manual_seed(31)
    bf, f32 = torch.bfloat16, torch.float32
    # name: (kernel, plain, cases (tag: b, t or s, kvn, d, row dtype))
    forms = {
        "paged_append_decode_fp8kv": (
            pa.paged_append_decode_fp8kv, pa.paged_append_decode_ref,
            {"llama2-7b": (8, 0, 32, 128, bf), "gqa": (8, 0, 4, 64, f32)}),
        "paged_append_prefill_fp8kv": (
            pa.paged_append_prefill_fp8kv, pa.paged_append_prefill_ref,
            {"llama2-7b": (8, 128, 32, 128, bf),
             "ragged": (8, 100, 32, 128, bf), "gqa": (4, 300, 4, 64, f32)}),
        "paged_append_span_fp8kv": (
            pa.paged_append_span_fp8kv, pa.paged_append_span_ref,
            {"llama2-7b": (8, 5, 32, 128, bf),
             "gqa f32 span 8": (8, 8, 8, 128, f32)}),
    }
    for name, (kern, ref, cases) in forms.items():
        main = None
        for tag, (b, s, kvn, d, dtype) in cases.items():
            ps, mp, layer = 128, 3, 1
            prefill = "prefill" in name
            pools = _e4m3_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
            shape = (b, max(s, 1)) if s or prefill else (b,)
            qkv = torch.randn((*shape, 3 * kvn * d), generator=gen,
                              device=dev, dtype=dtype) * 300
            nk = qkv[..., kvn * d:2 * kvn * d].reshape(*shape, kvn, d)
            nv = qkv[..., 2 * kvn * d:].reshape(*shape, kvn, d)  # strided
            tables = _tables(torch, dev, b, mp)
            pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
            if "span" in name:
                pos[0] = ps - 2                 # a span across a page
            args = (nk, nv, tables) + (() if prefill else (pos,)) + (layer,)
            a, r = [p.clone() for p in pools], [p.clone() for p in pools]
            kern(*a, *args)
            ref(*r, *args)
            torch.cuda.synchronize()
            err = sum(_codes_err(torch, x[:, :-1], y[:, :-1])
                      for x, y in zip(a, r))
            nan = int((a[0].view(torch.uint8) & 0x7F == 0x7F).sum())
            print(f"[kernels] {name} {tag}: {err} bytes apart (tol 0, "
                  f"byte-equal; trash page excluded); {nan} NaN codes "
                  f"(rows past 464)", flush=True)
            require(err == 0 and nan > 0, f"{name} {tag} disagrees: {err}, "
                    f"NaN codes {nan}")
            if main is not None:
                continue
            p1 = pools[0].shape[1]
            if prefill:
                npg = -(-s // ps)
                rows = 2 * b * s * kvn * d * nk.element_size()
                written = 2 * b * npg * ps * kvn * d
                idx = tables[:, :npg].long()
                idx = torch.where(idx >= 0, idx, p1 - 1).reshape(-1)
                ck = nk.reshape(b, npg, ps, kvn, d).transpose(2, 3).reshape(
                    b * npg, kvn, ps, d)
                cv = nv.reshape(b, npg, ps, kvn, d).transpose(2, 3).reshape(
                    b * npg, kvn, ps, d)

                def library():
                    for pool, x in ((a[0], ck), (a[1], cv)):
                        pool.view(torch.uint8)[layer].index_copy_(
                            0, idx, _cast_lib(torch, x))
            else:
                t = max(s, 1)
                rows = 2 * b * t * kvn * d * nk.element_size()
                written = 2 * b * t * kvn * d
                page, slot = pa.span_slots(tables, pos, t, p1, ps)
                heads = torch.arange(kvn, device=dev)
                ix = (page[:, :, None], heads[None, None], slot[:, :, None])
                xk, xv = (x.reshape(b, t, kvn, d) for x in (nk, nv))

                def library():
                    for pool, x in ((a[0], xk), (a[1], xv)):
                        pool.view(torch.uint8)[layer].index_put_(
                            ix, _cast_lib(torch, x))
            bms, by = bound_ms(rows + written + tables.numel() * 4 + b * 4,
                               0.0, dname(torch, dtype))
            main = dict(max_abs_err=float(err),
                        ms=time_ms(torch, lambda: kern(*a, *args)),
                        plain_ms=time_ms(torch, lambda: ref(*r, *args)),
                        library_ms=time_ms(torch, library),
                        bound_ms=bms, bound_by=by)
        results[name] = main


def _cast_sdpa(torch, q4, pk, pv, tables, layer, mask):
    """The library yardstick of the FP8-KV attention forms: gather the e4m3
    pages (exact f32), cast them to q's dtype (torch operations), then
    scaled_dot_product_attention."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    ck, cv = gather_dense(pk[layer], pv[layer], tables)
    return F.scaled_dot_product_attention(q4, ck.to(q4.dtype),
                                          cv.to(q4.dtype), attn_mask=mask)


def check_paged_decode_fp8kv(torch, dev, results, extra):
    """Form 4e against its plain version by the rounding rule, at kernel
    4's cases: the bench shape (the row), GQA with a dead slot, the split
    edges and the long step's shape (B 8, kv_len 4096; timed)."""
    from simplellminference_tpu_torch.ops.attention.paged_decode import (
        paged_flash_decode_fp8kv, paged_flash_decode_ref)
    gen = torch.Generator(device=dev).manual_seed(32)
    bf, f32 = torch.bfloat16, torch.float32
    cases = {
        "llama2-7b": (32, 32, 128, bf, [128 + 4 * i for i in range(8)], 2,
                      False),
        "gqa-f32": (32, 4, 64, f32, [1, 5, 128, 200, 0, 129], 2, True),
        "gqa-bf16": (32, 4, 64, bf, [1, 5, 128, 200, 0, 129], 2, True),
        "llama2-7b kv_len 4096": (32, 32, 128, bf, [4096] * 8, 32, False),
    }
    for i, lens in enumerate(_split_edge_lens(32, 2048)):
        cases[f"split edges mha-bf16 {i}"] = (32, 32, 128, bf, lens, 16, True)
    for i, lens in enumerate(_split_edge_lens(4, 2048, rows=8)):
        cases[f"split edges gqa-f32 {i}"] = (32, 4, 64, f32, lens, 16, True)
    timed = ("llama2-7b", "llama2-7b kv_len 4096")
    for tag, (n, kvn, d, dtype, lens, mp, dead) in cases.items():
        b, ps, layer = len(lens), 128, 1
        pk, pv = _e4m3_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        q = torch.randn((b, n, d), generator=gen, device=dev, dtype=dtype)
        tables = _tables(torch, dev, b, mp, dead_last=dead)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = paged_flash_decode_fp8kv(q, pk, pv, tables, kv_lens, layer)
        want = paged_flash_decode_ref(q, pk, pv, tables, kv_lens, layer)
        torch.cuda.synchronize()
        zero = [i for i in range(b) if lens[i] == 0] + [b - 1] * dead
        err = _attn_check(torch, "paged_flash_decode_fp8kv", tag, got, want,
                          zero)
        if tag not in timed:
            continue
        mask = (torch.arange(mp * ps, device=dev)[None, None, None, :]
                < kv_lens.long()[:, None, None, None])
        es = q.element_size()
        # q in, out; each live key's e4m3 K and V rows
        kvb, live = _decode_bytes(torch, tables, kv_lens, ps, kvn * 2 * d)
        nbytes = 2 * b * n * d * es + kvb + tables.numel() * 4 + b * 4
        bms, by = bound_ms(nbytes, 4.0 * n * d * live, dname(torch, dtype))
        q4 = q[:, :, None]
        res = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: paged_flash_decode_fp8kv(
                q, pk, pv, tables, kv_lens, layer)),
            plain_ms=time_ms(torch, lambda: paged_flash_decode_ref(
                q, pk, pv, tables, kv_lens, layer)),
            library_ms=time_ms(torch, lambda: _cast_sdpa(
                torch, q4, pk, pv, tables, layer, mask)),
            bound_ms=bms, bound_by=by)
        extra.append(("paged_flash_decode_fp8kv", tag, res))
        results.setdefault("paged_flash_decode_fp8kv", res)


def check_paged_prefill_fp8kv(torch, dev, results, extra):
    """Form 8e by the prefill rule at kernel 8's cases: the prefix paths'
    suffix batch and chunk (bf16, the tensor-core kernel; timed, the first
    the row) and a GQA f32 case (the FMA kernel) with ragged offsets, an
    unmapped page inside kv_len and a padding row."""
    from simplellminference_tpu_torch.ops.attention.paged_prefill import (
        paged_flash_prefill_fp8kv, paged_flash_prefill_ref)
    gen = torch.Generator(device=dev).manual_seed(33)
    bf, f32 = torch.bfloat16, torch.float32
    cases = {
        "llama2-7b suffix batch": (64, 32, 32, 128, 128, [512] * 8,
                                   [540 + 5 * i for i in range(8)], bf,
                                   False),
        "llama2-7b chunk": (256, 32, 32, 128, 128, [512], [576], bf, False),
        "tinyllama-gqa f32": (100, 32, 4, 64, 16, [0, 48, 16, 0],
                              [100, 130, 77, 1], f32, True),
    }
    timed = list(cases)[:2]
    for tag, (sq, n, kvn, d, ps, offs, lens, dtype, unmapped) in \
            cases.items():
        b = len(offs)
        mp = -(-max(o + sq for o in offs) // ps)
        pk, pv = _e4m3_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        tables = _tables(torch, dev, b, mp, dead_last=unmapped)
        if unmapped:
            tables[2, 1] = -1           # inside row 2's kv_len
        q = torch.randn((b, sq, n, d), generator=gen, device=dev,
                        dtype=dtype)
        off_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        kv_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        layer = 1
        got = paged_flash_prefill_fp8kv(q, pk, pv, tables, kv_t, off_t,
                                        layer)
        want = paged_flash_prefill_ref(q, pk, pv, tables, kv_t, off_t, layer)
        torch.cuda.synchronize()
        ok, err, note = _prefill_rule(torch, got, want)
        print(f"[kernels] paged_flash_prefill_fp8kv {tag} (B={b} Sq={sq} "
              f"N={n} kvN={kvn} D={d} ps={ps}): max|err| {err:.3e} ({note}); "
              f"every row finite: {bool(torch.isfinite(got).all())}",
              flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"paged_flash_prefill_fp8kv {tag} disagrees: {err} ({note})")
        if tag not in timed:
            continue
        es = q.element_size()
        keys = sum(min(o + r + 1, ln) for o, ln in zip(offs, lens)
                   for r in range(sq))
        kv_rows = sum(min(ln, o + sq) for o, ln in zip(offs, lens))
        nbytes = (2 * b * sq * n * d * es + kv_rows * kvn * 2 * d
                  + tables.numel() * 4 + 2 * b * 4)
        bms, by = bound_ms(nbytes, 4.0 * n * d * keys, dname(torch, dtype))
        key_pos = torch.arange(mp * ps, device=dev)
        q_pos = off_t.long()[:, None] + torch.arange(sq, device=dev)[None]
        mask = ((key_pos[None, None] <= q_pos[:, :, None])
                & (key_pos[None, None] < kv_t.long()[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        r = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: paged_flash_prefill_fp8kv(
                q, pk, pv, tables, kv_t, off_t, layer)),
            plain_ms=time_ms(torch, lambda: paged_flash_prefill_ref(
                q, pk, pv, tables, kv_t, off_t, layer)),
            library_ms=time_ms(torch, lambda: _cast_sdpa(
                torch, qt, pk, pv, tables, layer, mask)),
            bound_ms=bms, bound_by=by)
        extra.append(("paged_flash_prefill_fp8kv", tag, r))
        results.setdefault("paged_flash_prefill_fp8kv", r)


def _e4m3_ordinal(torch, x):
    """e4m3 codes in value order: +-0 both 0, one step per code."""
    u = x.view(torch.uint8).int()
    return torch.where(u >= 128, -(u & 0x7F), u & 0x7F)


def check_fused_qkv_fp8kv(torch, dev, results, extra):
    """Form 6e against its plain version: q by kernel 6's rule, the k/v
    codes at most one e4m3 step apart (sums in another order may cross a
    rounding midpoint; the share printed), every other pool byte equal; at
    the 7B decode shape (b 8, timed on 6m and on the FMA kernel), an
    unmapped row, b 1 and 64, and GQA f32 and bf16, the weight scales
    raised so that some k/v pass 464. And 6ek, the form with a kv_layer
    (the grouped engine's e4m3 ring pools), at Mistral-7B's decode (8 rows
    at positions past its window of 4096 over ring tables of R pages,
    weights of layer 1, pool layer 0; timed) and in f32 with a dead row,
    every byte of the weight layer's pool layer left as it was."""
    from simplellminference_tpu_torch.ops import qkv_fused as qf
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.qkv_fused import (
        fused_qkv_append_fp8kv, fused_qkv_append_ref)
    gen = torch.Generator(device=dev).manual_seed(34)
    bf, f32 = torch.bfloat16, torch.float32
    cases = {
        "llama2-7b": (8, 4096, 32, 32, 128, bf, False),
        "llama2-7b unmapped row": (8, 4096, 32, 32, 128, bf, True),
        "llama2-7b m1": (1, 4096, 32, 32, 128, bf, False),
        "llama2-7b m64": (64, 4096, 32, 32, 128, bf, True),
        "tinyllama-gqa f32": (8, 2048, 32, 4, 64, f32, True),
        "tinyllama-gqa bf16": (5, 2048, 32, 4, 64, bf, False),
        # 6ek: Mistral-7B's e4m3 ring pools at a kv_layer
        "mistral-7b kv_layer": (8, 4096, 32, 8, 128, bf, False),
        "mistral-7b kv_layer f32": (4, 4096, 32, 8, 128, f32, True),
    }
    for tag, (b, h, n, kvn, d, xdt, unmapped) in cases.items():
        ps, mp, layer = 128, 3, 1
        ring = "kv_layer" in tag
        kv_layer = 0 if ring else None
        kli = layer if kv_layer is None else kv_layer
        form = ("fused_qkv_append_fp8kv_kv_layer" if ring
                else "fused_qkv_append_fp8kv")
        nq = (n + 2 * kvn) * d
        wq, ws = _qweight(torch, gen, dev, (2, h, nq), 1)
        ws = ws * 300                           # k/v past 464 too
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(xdt)
        x = torch.randn((b, h), generator=gen, device=dev).to(xdt)
        if ring:
            pos = (4200 + 37 * torch.arange(b, device=dev)).to(torch.int32)
            mp = -(-(int(pos.max()) + 1) // ps)
            pk, pv = _e4m3_pools(torch, gen, dev, 2, b * MISTRAL_RING, kvn,
                                 ps, d)
            tables = _ring_tables(torch, dev, b, MISTRAL_RING, mp)
            if unmapped:
                tables[-1] = -1         # a dead row: its write goes to trash
        else:
            pk, pv = _e4m3_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
            tables = _tables(torch, dev, b, mp, dead_last=False)
            pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
            if unmapped:
                tables[-1, int(pos[-1]) // ps] = -1
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
        qa, *_ = fused_qkv_append_fp8kv(x, nw, wq, ws, sin, cos, *a, layer,
                                        pos, tables, n_heads=n, kv_heads=kvn,
                                        kv_layer=kv_layer)
        qr, *_ = fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, layer,
                                      pos, n_heads=n, kv_heads=kvn,
                                      tables=tables, kv_layer=kv_layer)
        torch.cuda.synchronize()
        page = tables.long()[torch.arange(b, device=dev), pos.long() // ps]
        page = torch.where(page >= 0, page, pk.shape[1] - 1)
        written = torch.zeros(pk.shape, dtype=torch.bool, device=dev)
        written[kli, page, :, pos.long() % ps] = True
        err = max_err(qa, qr)
        lim_q = (F32_REL * float(qr.abs().max()) if xdt == f32
                 else TOL["bfloat16"] * float(qr.float().std()))
        steps = max(int((_e4m3_ordinal(torch, ta[written])
                         - _e4m3_ordinal(torch, tr[written])).abs().max())
                    for ta, tr in zip(a, r))
        share = sum(_codes_err(torch, ta[written], tr[written])
                    for ta, tr in zip(a, r)) / (2 * int(written.sum()))
        nan = sum(int((tr[written].view(torch.uint8) & 0x7F == 0x7F).sum())
                  for tr in r)
        untouched = all(_codes_err(torch, ta[~written], tr[~written]) == 0
                        for ta, tr in zip(a, r))
        regime = qf.qkv_regime(b, h, nq, d, xdt)
        print(f"[kernels] {form} {tag} ({regime}; layer {layer}, pool layer "
              f"{kli}): q max|err| {err:.3e} (tol {lim_q:.3e}); k/v codes at "
              f"most {steps} step apart (tol 1), {share:.3e} of them differ; "
              f"{nan} NaN codes (k/v past 464); other entries equal: "
              f"{untouched}", flush=True)
        require(bool(torch.isfinite(qa).all()) and err <= lim_q
                and steps <= 1 and untouched and nan > 0,
                f"{form} {tag} disagrees: {err}, {steps}, {untouched}, "
                f"{nan}")
        if regime != "mma" or tag not in ("llama2-7b", "mistral-7b kv_layer"):
            continue
        nbytes = _qkv_nbytes(h, nq, b, n, kvn, d, x.element_size(),
                             nw.element_size(), d,
                             tables.numel() * 4 + b * 4)
        qt, st = _int8pack(torch, wq[layer], ws[layer], xdt)
        _time_qkv(torch, form, tag,
                  lambda: fused_qkv_append_fp8kv(
                      x, nw, wq, ws, sin, cos, *a, layer, pos, tables,
                      n_heads=n, kv_heads=kvn, kv_layer=kv_layer),
                  lambda: fused_qkv_append_ref(
                      x, nw, wq, ws, sin, cos, *r, layer, pos, n_heads=n,
                      kv_heads=kvn, tables=tables, kv_layer=kv_layer),
                  qr, nbytes, 2.0 * b * h * nq, dname(torch, xdt),
                  (x, qt, st), results, extra, max(err, float(steps)))


def _arena(torch, gen, dev, layers, rows, kvn, smax, d, dtype):
    shape = (layers, rows, kvn, smax, d)
    return (torch.randn(shape, generator=gen, device=dev, dtype=dtype),
            torch.randn(shape, generator=gen, device=dev, dtype=dtype))


def draft_arena_shape() -> tuple[int, int]:
    """Layers and slots per row of the `draft` path's arena: TinyLlama-
    1.1B's depth and the Engine's slot count for that path's engine
    configuration (:func:`serve_draft` checks the arena it serves)."""
    from simplellminference_tpu_torch.core.config import ModelConfig
    from simplellminference_tpu_torch.engine.engine import draft_arena_slots
    return (ModelConfig.tinyllama_1_1b(num_layers=DRAFT_LAYERS).num_layers,
            draft_arena_slots(spec_engine_config(DRAFT_TOKENS, "bf16", 8, 0)))


def check_kv_append(torch, dev, results, extra):
    """Kernel 12 byte-equal to its plain version over the whole arena: the
    dense paths' decode (S = 1) and prefill (S = 128) calls at 7B width,
    bf16; the `draft` path's calls into its own arena (22 layers, 8320
    slots, kvN 4, D 64, bf16: the prefill of 8 gathered rows at S = 128,
    the rollout's B + 1 = 9 rows at S = 1); f32 GQA rows at and past Smax
    (dropped) and a prefill block running past it; fewer rows than the
    arena. Timed at the decode call (the row) and the prefill call."""
    from simplellminference_tpu_torch.ops.kv_append import (kv_append,
                                                            kv_append_ref)
    gen = torch.Generator(device=dev).manual_seed(31)
    bf, f32 = torch.bfloat16, torch.float32
    dl, dslots = draft_arena_shape()
    # tag: (layers, rows, arena rows, S, kvN, D, Smax, dtype, offsets)
    cases = {
        "llama2-7b decode": (2, 8, 8, 1, 32, 128, 256, bf,
                             [128 + 4 * i for i in range(8)]),
        "llama2-7b prefill": (2, 8, 8, 128, 32, 128, 256, bf, [0] * 8),
        "draft prefill": (dl, 8, 8, 128, 4, 64, dslots, bf, [0] * 8),
        "draft rollout": (dl, 9, 9, 1, 4, 64, dslots, bf,
                          [128 + 8 * i for i in range(8)] + [0]),
        "gqa f32 decode at/past Smax": (2, 9, 9, 1, 4, 64, 384, f32,
                                        [0, 1, 383, 384, 390, 7, 100, 200,
                                         0]),
        "gqa f32 prefill past Smax": (2, 4, 5, 128, 4, 64, 384, f32,
                                      [0, 8, 300, 384]),
        "bf16 S=8 odd offsets": (2, 3, 5, 8, 4, 64, 384, bf, [3, 17, 380]),
    }
    timed = list(cases)[:2]
    for tag, (nl, b, rows, s, kvn, d, smax, dtype, offs) in cases.items():
        layer = nl - 1
        ck, cv = _arena(torch, gen, dev, nl, rows, kvn, smax, d, dtype)
        qkv = torch.randn((b, s, 3 * kvn * d), generator=gen, device=dev,
                          dtype=dtype)
        nk = qkv[..., kvn * d:2 * kvn * d].reshape(b, s, kvn, d)
        nv = qkv[..., 2 * kvn * d:].reshape(b, s, kvn, d)   # strided views
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        a, r = (ck.clone(), cv.clone()), (ck.clone(), cv.clone())
        kv_append(*a, nk, nv, layer, off)
        kv_append_ref(*r, nk, nv, layer, off)
        torch.cuda.synchronize()
        err = max(max_err(x, y) for x, y in zip(a, r))
        print(f"[kernels] kv_append {tag} (B={b} into {rows} rows, S={s}, "
              f"L={nl}, Smax={smax}): max|err| {err} (tol 0, exact; whole "
              f"arena)",
              flush=True)
        require(err == 0.0, f"kv_append {tag} disagrees: {err}")
        if tag not in timed:
            continue
        es = ck.element_size()
        nbytes = 2 * 2 * b * s * kvn * d * es + b * 4
        bms, by = bound_ms(nbytes, 0.0, dname(torch, dtype))
        # the library yardstick: index_copy_ of the flattened rows
        slot = off.long()[:, None, None] + torch.arange(s, device=dev)
        row = ((torch.arange(b, device=dev)[:, None, None] * kvn
                + torch.arange(kvn, device=dev)[None, :, None]) * smax
               + slot).reshape(-1)
        sk = nk.permute(0, 2, 1, 3).reshape(-1, d).contiguous()
        sv = nv.permute(0, 2, 1, 3).reshape(-1, d).contiguous()
        fk, fv = (x[layer].view(-1, d) for x in a)

        def library():
            fk.index_copy_(0, row, sk)
            fv.index_copy_(0, row, sv)

        res = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: kv_append(*a, nk, nv, layer, off)),
            plain_ms=time_ms(torch, lambda: kv_append_ref(*r, nk, nv, layer,
                                                          off)),
            library_ms=time_ms(torch, library),
            bound_ms=bms, bound_by=by)
        extra.append(("kv_append", tag, res))
        results.setdefault("kv_append", res)


def check_flash_decode(torch, dev, results, extra):
    """Kernel 13 against its plain version: the dense 7B decode (B 8,
    N = kvN 32, D 128, bf16, kv_len ~150, the row), kv_len 0, 1, 161,
    Smax and past Smax, the TinyLlama draft's shape (N 32, kvN 4, D 64:
    GQA group 8, B + 1 = 9 rows) in bf16 and f32, the `draft` path's
    rollout over its own arena (22 layers, 8320 slots, bf16) at kv_len
    ~150 and at the arena's edges, and fewer sequences than arena rows.
    Timed at the row and at the draft rollout's call (8 rows at kv_len
    ~150 and the pad row)."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.ops.attention.flash_decode import (
        flash_decode, flash_decode_ref)
    gen = torch.Generator(device=dev).manual_seed(32)
    bf, f32 = torch.bfloat16, torch.float32
    edge = [0, 1, 161, 256, 300, 17, 128, 255]
    dl, dslots = draft_arena_shape()
    # tag: (layers, B, arena rows, N, kvN, D, Smax, dtype, kv_lens)
    cases = {
        "llama2-7b": (2, 8, 8, 32, 32, 128, 256, bf,
                      [145 + 2 * i for i in range(8)]),
        "llama2-7b edge lens": (2, 8, 8, 32, 32, 128, 256, bf, edge),
        "llama2-7b f32 edge lens": (2, 8, 8, 32, 32, 128, 256, f32, edge),
        "draft bf16": (2, 9, 9, 32, 4, 64, 384, bf, edge + [0]),
        "draft f32": (2, 9, 9, 32, 4, 64, 384, f32, [1, 384, 161, 0, 5, 383,
                                                     64, 65, 2]),
        "rows < arena": (2, 3, 5, 32, 4, 64, 384, f32, [10, 0, 200]),
        "draft rollout": (dl, 9, 9, 32, 4, 64, dslots, bf,
                          [145 + 2 * i for i in range(8)] + [1]),
        "draft arena edge lens": (dl, 9, 9, 32, 4, 64, dslots, bf,
                                  [0, 1, 161, dslots - 1, dslots,
                                   dslots + 5, 4097, 128, 1]),
    }
    for i, edge in enumerate(_split_edge_lens(4, 2048, rows=8)):
        cases[f"split edges gqa bf16 {i}"] = (2, len(edge), len(edge) + 1, 32,
                                              4, 64, 2048, bf, edge)
    timed = ("llama2-7b", "draft rollout")
    for tag, (nl, b, rows, n, kvn, d, smax, dtype, lens) in cases.items():
        layer = nl - 1
        ck, cv = _arena(torch, gen, dev, nl, rows, kvn, smax, d, dtype)
        q = torch.randn((b, n, d), generator=gen, device=dev, dtype=dtype)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = flash_decode(q, ck, cv, kv_lens, layer=layer)
        want = flash_decode_ref(q, ck, cv, kv_lens, layer=layer)
        torch.cuda.synchronize()
        err = _attn_check(torch, "flash_decode",
                          f"{tag} (B={b} N={n} kvN={kvn} D={d} L={nl} "
                          f"Smax={smax})", got, want,
                          [i for i in range(b) if lens[i] <= 0])
        if tag not in timed:
            continue
        live = sum(min(ln, smax) for ln in lens)
        es = q.element_size()
        nbytes = 2 * b * n * d * es + 2 * live * kvn * d * es + b * 4
        bms, by = bound_ms(nbytes, 4.0 * n * d * live, dname(torch, dtype))
        top = max(lens)
        k4, v4 = ck[layer, :b, :, :top], cv[layer, :b, :, :top]
        mask = (torch.arange(top, device=dev)[None, None, None, :]
                < kv_lens.long()[:, None, None, None])
        q4 = q[:, :, None]
        if kvn != n:   # GQA: SDPA takes the K/V heads repeated per group
            k4 = k4.repeat_interleave(n // kvn, dim=1)
            v4 = v4.repeat_interleave(n // kvn, dim=1)
        res = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: flash_decode(q, ck, cv, kv_lens,
                                                   layer=layer)),
            plain_ms=time_ms(torch, lambda: flash_decode_ref(
                q, ck, cv, kv_lens, layer=layer)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask)),
            bound_ms=bms, bound_by=by)
        extra.append(("flash_decode", tag, res))
        results.setdefault("flash_decode", res)


def check_fused_qkv_dense(torch, dev, results, extra):
    """Form 6d against its plain version: bench.py's Generator call (7B,
    8 rows into an 8-row bf16 arena, the row), the draft rollout's B + 1
    rows into a (B + 1)-row arena (TinyLlama GQA, f32, a slot at Smax
    dropped), and fewer rows than the arena (bf16)."""
    from simplellminference_tpu_torch.ops import qkv_fused as qf
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.qkv_fused import (
        fused_qkv_append_dense, fused_qkv_append_ref)
    gen = torch.Generator(device=dev).manual_seed(33)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (B, arena rows, H, N, kvN, D, Smax, dtype, offsets); every bf16
    # case is timed on 6m and on the FMA kernel
    cases = {
        "llama2-7b": (8, 8, 4096, 32, 32, 128, 256, bf,
                      [128 + 4 * i for i in range(8)]),
        "llama2-7b m1": (1, 8, 4096, 32, 32, 128, 256, bf, [255]),
        "draft B+1 f32": (9, 9, 2048, 32, 4, 64, 384, f32,
                          [0, 383, 384, 10, 200, 1, 2, 3, 0]),
        "draft B+1 bf16 (edges)": (9, 9, 2048, 32, 4, 64, 384, bf,
                                   [0, 383, 384, 10, 200, 1, 2, 3, 0]),
        "rows < arena bf16": (5, 8, 2048, 32, 4, 64, 384, bf,
                              [7, 0, 100, 383, 50]),
    }
    for tag, (b, rows, h, n, kvn, d, smax, dt, offs) in cases.items():
        layer = 1
        nq = (n + 2 * kvn) * d
        wq, ws = _qweight(torch, gen, dev, (2, h, nq), 1)
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(dt)
        x = torch.randn((b, h), generator=gen, device=dev).to(dt)
        ck, cv = _arena(torch, gen, dev, 2, rows, kvn, smax, d, dt)
        pos = torch.tensor(offs, dtype=torch.int32, device=dev)
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        a, r = (ck.clone(), cv.clone()), (ck.clone(), cv.clone())
        qa, *_ = fused_qkv_append_dense(x, nw, wq, ws, sin, cos, *a, layer,
                                        pos, n_heads=n, kv_heads=kvn)
        qr, *_ = fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, layer,
                                      pos, n_heads=n, kv_heads=kvn)
        torch.cuda.synchronize()
        written = torch.zeros(ck.shape, dtype=torch.bool, device=dev)
        for i, o in enumerate(offs):
            if 0 <= o < smax:
                written[layer, i, :, o] = True
        err = max_err(qa, qr)
        kv_err = max(max_err(ta[written], tr[written])
                     for ta, tr in zip(a, r))
        untouched = all(torch.equal(ta[~written], tr[~written])
                        for ta, tr in zip(a, r))
        if dt == torch.float32:
            lim_q = F32_REL * float(qr.abs().max())
            lim_kv = F32_REL * max(float(tr[written].abs().max())
                                   for tr in r)
        else:
            lim_q = TOL["bfloat16"] * float(qr.float().std())
            lim_kv = TOL["bfloat16"] * max(float(tr[written].float().std())
                                           for tr in r)
        regime = qf.qkv_regime(b, h, nq, d, dt)
        print(f"[kernels] fused_qkv_append_dense {tag} ({regime}): q "
              f"max|err| {err:.3e} (tol {lim_q:.3e}); k/v rows {kv_err:.3e} "
              f"(tol {lim_kv:.3e}); other arena entries equal: {untouched}",
              flush=True)
        require(bool(torch.isfinite(qa).all()) and err <= lim_q
                and kv_err <= lim_kv and untouched,
                f"fused_qkv_append_dense {tag} disagrees: {err}, {kv_err}, "
                f"{untouched}")
        if regime != "mma":
            continue
        nbytes = _qkv_nbytes(h, nq, b, n, kvn, d, x.element_size(),
                             nw.element_size(), d * ck.element_size(), b * 4)
        qt, st = _int8pack(torch, wq[layer], ws[layer], dt)
        _time_qkv(torch, "fused_qkv_append_dense", tag,
                  lambda: fused_qkv_append_dense(
                      x, nw, wq, ws, sin, cos, *a, layer, pos, n_heads=n,
                      kv_heads=kvn),
                  lambda: fused_qkv_append_ref(
                      x, nw, wq, ws, sin, cos, *r, layer, pos, n_heads=n,
                      kv_heads=kvn),
                  qr, nbytes, 2.0 * b * h * nq, dname(torch, dt),
                  (x, qt, st), results, extra, max(err, kv_err))


def _int4_weight(torch, gen, dev, k, n, groups, zs=False, layers=2):
    """Random split-half packed bytes for a logical [layers, K, N] INT4
    weight (every byte value, so both nibbles reach -8 and 7), f32 scales
    around bench.py's K**-0.5 / 7 varied per column, and with ``zs`` zero
    points (z - 8) * s for z in [0, 16) (the AWQ form)."""
    q = torch.randint(-128, 128, (layers, k // 2, n), generator=gen,
                      device=dev, dtype=torch.int8)
    s = (torch.rand((layers, groups, n), generator=gen, device=dev) + 0.5
         ) * (k ** -0.5 / 7.0)
    z = None
    if zs:
        z = (torch.randint(0, 16, s.shape, generator=gen, device=dev) - 8
             ).float() * s
    return q, s, z


def _matmul_rule(torch, got, want, odt):
    """The INT8 product's rule: f32 outputs within F32_REL of the output's
    largest magnitude; bf16 outputs within one bf16 ulp beyond that."""
    err = max_err(got, want)
    slack = F32_REL * float(want.float().abs().max())
    if odt == torch.float32:
        return err <= slack, err, f"tol {slack:.3e} = {F32_REL:g} x max|out|"
    diff = (got.float() - want.float()).abs()
    ulp = _bf16_ulp(torch, torch.maximum(got.float().abs(),
                                         want.float().abs()))
    return (bool((diff <= ulp + slack).all()), err,
            f"tol one bf16 ulp of each output + {slack:.3e}")


def _rounding_rule(torch, got, want):
    """The rule of the attention kernels, which compute in f32 as their
    plain versions do (another summation order) and round once to the
    output dtype: each element within F32_REL of the output's largest
    magnitude, plus one bf16 ulp of itself for bf16 outputs. Returns
    (ok, max|err|, the largest share of its limit an element takes,
    the limit's text)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    lim = torch.full_like(diff, F32_REL * float(w.abs().max()))
    note = f"tol {F32_REL:g} x max|out|"
    if got.dtype == torch.bfloat16:
        lim = lim + _bf16_ulp(torch, torch.maximum(g.abs(), w.abs()))
        note = "tol one bf16 ulp of each output + " + note[4:]
    share = float((diff / lim.clamp_min(1e-30)).max()) if diff.numel() else 0.0
    return share <= 1.0, float(diff.max()) if diff.numel() else 0.0, share, note


def _prefill_rule(torch, got, want):
    """Kernels 3 and 8: bf16 outputs (the tensor-core forms) by
    :func:`_rounding_rule`, f32 outputs (the FMA forms) within TOL.
    Returns (ok, max|err|, the limit's text with the worst share)."""
    if got.dtype == torch.bfloat16:
        ok, err, share, note = _rounding_rule(torch, got, want)
        return ok, err, (f"{note}; the worst element at {share:.3f} of its "
                         f"limit")
    err = max_err(got, want)
    tol = TOL[dname(torch, got.dtype)]
    return err <= tol, err, f"tol {tol:g}"


def _int4pack_library(torch, x, q, s, z, k):
    """torch._weight_int4pack_mm on the same weights repacked for it
    (uint4 codes c + 8 as [N, K/2] bytes, scales and zero terms -zs over
    groups of 128 rows, bf16), if the card's PyTorch has it; else
    torch.matmul on the dequantized bf16 weight. The scale groups must be
    128 rows or a multiple. Returns (fn, name)."""
    from simplellminference_tpu_torch.ops import ref_ops
    rep = k // 128 // s.shape[0]               # 128-row groups per group
    require(rep >= 1, "library INT4 needs scale groups of >= 128 rows")
    xb = x.to(torch.bfloat16)
    try:
        u = (ref_ops.unpack_int4(q).int() + 8).t().contiguous()  # [N, K]
        wp = torch._convert_weight_to_int4pack(
            ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
        zt = torch.zeros_like(s) if z is None else -z
        sz = torch.stack([s.repeat_interleave(rep, 0),
                          zt.repeat_interleave(rep, 0)], -1).to(
            torch.bfloat16).contiguous()

        def fn():
            return torch._weight_int4pack_mm(xb, wp, 128, sz)
        fn()
        return fn, "torch._weight_int4pack_mm (group 128)"
    except (AttributeError, RuntimeError, TypeError) as e:
        w = ref_ops.dequantize_int4_groupwise(q, s, torch.bfloat16, zs=z)
        print(f"[kernels] torch._weight_int4pack_mm unavailable ({e}); "
              f"library time from torch.matmul on the bf16 weight",
              flush=True)
        return (lambda: torch.matmul(xb, w)), ("torch.matmul on the "
                                               "dequantized bf16 weight")


def check_quantized_matmul_int4(torch, dev, results, extra):
    from simplellminference_tpu_torch.ops.matmul import (
        quantized_matmul_int4, quantized_matmul_int4_ref,
        quantized_matmul_int4_zs)
    gen = torch.Generator(device=dev).manual_seed(14)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (m, k, n, scale groups, zero points, x dtype, out dtype, timed);
    # bench.py --quant int4: per-channel scales, every decode product at
    # M = 8 and the 8 x 128-row prefill, M = 1 (one request); the AWQ
    # form (group 128, zero points) at decode and prefill; ragged M and a
    # K whose K/2 is no multiple of 128. Each case prints its regime: the
    # tensor-core kernels take bf16 activations (mma.sync at M <= 8, wgmma
    # above), the FMA kernels f32 ones and misfit groups or K/2
    cases = {
        "llama2-7b wqkv decode": (8, 4096, 12288, 1, False, bf, bf, True),
        "llama2-7b wo decode": (8, 4096, 4096, 1, False, bf, bf, True),
        "llama2-7b gate_up decode": (8, 4096, 22016, 1, False, bf, bf, True),
        "llama2-7b down decode": (8, 11008, 4096, 1, False, bf, bf, True),
        "llama2-7b lm_head decode": (8, 4096, 32000, 1, False, bf, f32,
                                     True),
        "llama2-7b wqkv prefill": (1024, 4096, 12288, 1, False, bf, bf, True),
        "llama2-7b wqkv M=1": (1, 4096, 12288, 1, False, bf, bf, False),
        "llama2-7b gate_up prefill": (1024, 4096, 22016, 1, False, bf, bf,
                                      True),
        "llama2-7b down prefill": (1024, 11008, 4096, 1, False, bf, bf,
                                   True),
        "llama2-7b wo group128": (8, 4096, 4096, 32, False, bf, bf, False),
        "llama2-7b wqkv group128 f32": (8, 4096, 12288, 32, False, f32, f32,
                                        False),
        "llama2-7b down prefill group128": (1024, 11008, 4096, 86, False, bf,
                                            bf, False),
        "awq wqkv decode": (8, 4096, 12288, 32, True, bf, bf, True),
        "awq gate_up decode": (8, 4096, 22016, 32, True, bf, bf, False),
        "awq down decode f32": (8, 11008, 4096, 86, True, f32, f32, False),
        "awq wqkv prefill": (1024, 4096, 12288, 32, True, bf, bf, True),
        "awq lm_head per-channel": (8, 4096, 32000, 1, True, bf, f32, False),
        "ragged M=300 group128": (300, 4096, 4096, 32, True, bf, f32, False),
        "k4000 (K/2 2000) decode": (5, 4000, 3000, 1, False, f32, f32,
                                    False),
        "k2000 group200 prefill": (77, 2000, 1000, 10, True, f32, bf, False),
    }
    for tag, (m, k, n, groups, zs, xdt, odt, timed) in cases.items():
        q, s, z = _int4_weight(torch, gen, dev, k, n, groups, zs)
        x = torch.randn((m, k), generator=gen, device=dev).to(xdt)
        name = "quantized_matmul_int4_zs" if zs else "quantized_matmul_int4"
        fn = quantized_matmul_int4_zs if zs else quantized_matmul_int4
        regime = int4_regime(m, k, n, k // groups, xdt)

        def kern(x=x, q=q, s=s, z=z, fn=fn, odt=odt, layer=1):
            return fn(x, q, s, *((z,) if z is not None else ()),
                      out_dtype=odt, layer=layer)

        def plain(x=x, q=q, s=s, z=z, odt=odt):
            return quantized_matmul_int4_ref(x, q, s, out_dtype=odt,
                                             layer=1, zs=z)
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        ok, err, rule = _matmul_rule(torch, got, want, odt)
        print(f"[kernels] {name} {tag} (m={m} k={k} n={n} groups={groups}, "
              f"{regime}): max|err| {err:.3e} ({rule})", flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"{name} {tag} disagrees: {err}")
        if not timed:
            continue
        zl = None if z is None else z[1]
        lib, lib_name = _int4pack_library(torch, x, q[1], s[1], zl, k)
        print(f"[kernels] {name} {tag}: library ({lib_name}) max|lib - "
              f"plain| {max_err(lib(), want):.3e} of max|plain| "
              f"{float(want.float().abs().max()):.3e}", flush=True)
        wbytes = k // 2 * n + groups * n * 4 * (2 if zs else 1)
        nbytes = wbytes + m * k * x.element_size() + m * n * got.element_size()
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, dname(torch, xdt))
        r = dict(max_abs_err=err, ms=time_ms(torch, kern),
                 plain_ms=time_ms(torch, plain, iters=5),
                 library_ms=time_ms(torch, lib), bound_ms=bms, bound_by=by,
                 library=lib_name, regime=regime)
        if m <= 8:
            # decode over weights past the L2: enough layer copies that
            # the set exceeds it, each call the next copy (the same-input
            # time above may read the 8-45 MB weight from L2)
            copies = max(2, int(2 * L2_BYTES // wbytes) + 1)
            qr, sr, zr = _int4_weight(torch, gen, dev, k, n, groups, zs,
                                      layers=copies)
            turn = iter(range(1 << 30))

            def rotating(qr=qr, sr=sr, zr=zr, fn=fn, x=x, odt=odt,
                         copies=copies):
                return fn(x, qr, sr, *((zr,) if zr is not None else ()),
                          out_dtype=odt, layer=next(turn) % copies)
            r["cold_ms"] = time_ms(torch, rotating)
            # the host's share of a decode call: the wrapper's Python and
            # the launches, enqueued back to back (the queue stays short)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                kern()
            r["host_ms"] = (time.perf_counter() - t0) * 10.0
            torch.cuda.synchronize()
            print(f"[kernels] {name} {tag} ({regime}): {r['ms']:.6g} ms on "
                  f"the same inputs, {r['cold_ms']:.6g} ms over {copies} "
                  f"weight copies ({copies * wbytes / 1e6:.1f} MB, past the "
                  f"L2); bound {bms:.6g}; host {r['host_ms']:.6g} ms a "
                  f"call (wrapper and launches)", flush=True)
            del qr, sr, zr
        extra.append((name, tag, r))
        results.setdefault(name, r)
        if regime in ("mma", "wgmma"):
            results.setdefault("quantized_matmul_int4_" + regime, r)


def check_quantized_matmul_w8a8(torch, dev, results, extra):
    from simplellminference_tpu_torch.ops import matmul as mm
    from simplellminference_tpu_torch.ops.matmul import (
        quantize_activations_int8, quantized_matmul_w8a8,
        quantized_matmul_w8a8_ref)
    gen = torch.Generator(device=dev).manual_seed(15)
    bf, f32 = torch.bfloat16, torch.float32
    # the four products of a prefill dispatch of 7B (the w8a8 path's
    # chunks are 256 rows, its suffix batches 512; bench.py's whole-prompt
    # prefill 1024), per-channel (bench.py's weights) and group 128; the
    # timed ones on the int8 tensor cores (quantized_matmul_w8a8_wgmma)
    # but the group-64 wqkv, the dp4a kernel's row (groups off a multiple
    # of the 128-row slab)
    cases = {
        "llama2-7b wqkv M=1024 group64": (1024, 4096, 12288, 64, bf, bf,
                                          True),
        "llama2-7b wqkv M=1024": (1024, 4096, 12288, 1, bf, bf, True),
        "llama2-7b wo M=1024": (1024, 4096, 4096, 1, bf, bf, True),
        "llama2-7b gate_up M=1024": (1024, 4096, 22016, 1, bf, bf, True),
        "llama2-7b down M=1024": (1024, 11008, 4096, 1, bf, bf, True),
        "llama2-7b wqkv M=128": (128, 4096, 12288, 1, bf, bf, True),
        "llama2-7b wo M=128": (128, 4096, 4096, 1, bf, bf, False),
        "llama2-7b gate_up M=128": (128, 4096, 22016, 1, bf, bf, False),
        "llama2-7b down M=128": (128, 11008, 4096, 1, bf, bf, False),
        "llama2-7b wqkv M=1024 group128": (1024, 4096, 12288, 32, bf, bf,
                                           False),
        "llama2-7b down M=128 group128": (128, 11008, 4096, 86, bf, f32,
                                          False),
        "llama2-7b gate_up M=256 group128 f32": (256, 4096, 22016, 32, f32,
                                                 f32, False),
        "ragged M=300 wo group128": (300, 4096, 4096, 32, bf, f32, False),
        "ragged M=141 k1000 n136": (141, 1000, 136, 1, f32, bf, False),
    }
    regime_of = getattr(mm, "w8a8_regime", lambda *a: "dp4a")
    for tag, (m, k, n, groups, xdt, odt, timed) in cases.items():
        q, s = _qweight(torch, gen, dev, (2, k, n), groups)
        x = torch.randn((m, k), generator=gen, device=dev).to(xdt)
        x[1] = 0.0                              # a zero row: the 1e-10 floor

        def kern(x=x, q=q, s=s, odt=odt):
            return quantized_matmul_w8a8(x, q, s, out_dtype=odt, layer=1)

        def plain(x=x, q=q, s=s, odt=odt):
            return quantized_matmul_w8a8_ref(x, q, s, out_dtype=odt, layer=1)
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        ok, err, rule = _matmul_rule(torch, got, want, odt)
        regime = regime_of(m, k, n, k // groups)
        # per channel the integer sums are exact and the two f32 multiplies
        # come in the plain version's order: count outputs that differ at
        # all (0 wherever the plain version's f32 chunk sums are exact)
        apart = (f"; {int((got != want).sum())} of {got.numel()} outputs "
                 f"bit-unequal" if groups == 1 else "")
        print(f"[kernels] quantized_matmul_w8a8 {tag} (m={m} k={k} n={n} "
              f"groups={groups}, {regime}): max|err| {err:.3e} ({rule})"
              f"{apart}", flush=True)
        require(bool(torch.isfinite(got).all()) and ok and not got[1].any(),
                f"quantized_matmul_w8a8 {tag} disagrees: {err}")
        if not timed:
            continue
        q1, s1 = q[1].contiguous(), s[1]

        def library(x=x, q1=q1, s1=s1, odt=odt):
            xi, xs = quantize_activations_int8(x)
            return ((torch._int_mm(xi, q1).float() * s1) * xs).to(odt)
        nbytes = (m * k * x.element_size() + k * n + groups * n * 4
                  + m * n * got.element_size())
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, "int8")
        # grouped scales: no one PyTorch call sums int8 products per group
        r = dict(max_abs_err=err, ms=time_ms(torch, kern),
                 plain_ms=time_ms(torch, plain, iters=5),
                 library_ms=(time_ms(torch, library) if groups == 1
                             else None), bound_ms=bms, bound_by=by,
                 regime=regime)
        if groups > 1:
            r["library"] = "none for grouped scales"
        # the quantize ops (torch, outside the kernel as in the JAX
        # package) alone, and the kernel alone on their codes: their
        # shares of the wrapper's time
        quant_ms = time_ms(torch, lambda x=x: quantize_activations_int8(x))
        launch = getattr(mm, "w8a8_codes_launch", None)
        if launch is not None:
            xi, xs = quantize_activations_int8(x)
            r["kernel_ms"] = time_ms(torch, lambda: launch(xi, xs, q1, s1,
                                                           odt))
        alone = (f"; the kernel alone {r['kernel_ms']:.6g} ms"
                 if "kernel_ms" in r else "")
        print(f"[kernels] quantized_matmul_w8a8 {tag}: quantize ops "
              f"{quant_ms:.6g} ms of the wrapper's {r['ms']:.6g} "
              f"(share {quant_ms / r['ms']:.3f}){alone}", flush=True)
        name = "quantized_matmul_w8a8" + "_wgmma" * (regime == "wgmma")
        extra.append((name, tag, r))
        results.setdefault(name, r)
        del q, s
        torch.cuda.empty_cache()


def check_quantizers(torch, dev):
    """quantize_int4_groupwise (per channel and group 128, a 7B weight) and
    quantize_activations_int8 (1024 x 4096 rows, bf16 and f32, a zero
    row) on the card, byte-equal to the CPU's."""
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.matmul import (
        quantize_activations_int8)
    g = torch.Generator().manual_seed(16)
    w = torch.randn((4096, 12288), generator=g) * 4096 ** -0.5
    w[:, :5] *= 1e-3
    for gs in (4096, 128):
        qc, sc = ref_ops.quantize_int4_groupwise(w, gs)
        qg, sg = ref_ops.quantize_int4_groupwise(w.to(dev), gs)
        require(torch.equal(qc, qg.cpu()) and torch.equal(sc, sg.cpu()),
                f"quantize_int4_groupwise (group {gs}): card and CPU differ")
    x = torch.randn((1024, 4096), generator=g) * torch.rand(
        (1024, 1), generator=g) * 4
    x[7] = 0.0
    for dt in (torch.bfloat16, torch.float32):
        ic, sc = quantize_activations_int8(x.to(dt))
        ig, sg = quantize_activations_int8(x.to(dt).to(dev))
        require(torch.equal(ic, ig.cpu()) and torch.equal(sc, sg.cpu()),
                f"quantize_activations_int8 ({dname(torch, dt)}): card and "
                f"CPU differ")
    print("[kernels] quantize_int4_groupwise (7B wqkv, per channel and "
          "group 128) and quantize_activations_int8 (1024 x 4096, bf16 and "
          "f32, a zero row): card byte-equal to the CPU", flush=True)


# ------------------------------------------------------ sliding windows
# Mistral-7B-v0.1's config.json: "sliding_window": 4096 on every layer;
# the `mistral_window` path's chunk of 256 rows and pages of 128 tokens
# give a ring of (4096 + 256 - 2) // 128 + 2 = 35 pages a slot
# (engine.py:524)
WINDOW = 4096
MISTRAL_CHUNK = 256
MISTRAL_RING = (WINDOW + MISTRAL_CHUNK - 2) // 128 + 2


def _ring_tables(torch, dev, b, r, mp):
    """The grouped engine's ring tables: column j of slot s -> s*r + j%r."""
    return (torch.arange(b, device=dev)[:, None] * r
            + torch.arange(mp, device=dev)[None] % r).to(torch.int32)


def _poisoned(torch, tables, k_lo, ps, first):
    """``tables`` with every column that ends at or below key k_lo[b]
    pointing at one of the 4 NaN pages from ``first`` on: no window form
    may read them."""
    tb = tables.clone()
    cols = torch.arange(tables.shape[1], device=tables.device)
    below = (cols[None] + 1) * ps <= k_lo.long()[:, None]
    tb[below] = (first + cols[None].expand_as(tb)[below] % 4).to(torch.int32)
    return tb


def _ring_pools(torch, gen, dev, b, r, kvn, ps, d, dtype, quant):
    """Two layers of ring pools (b x r pages), 4 NaN pages after them and
    the trash page: bf16/f32 rows, or INT8 codes whose NaN is in the
    scale pools."""
    shape = (2, b * r + 5, kvn, ps, d)
    if quant:
        pk, pv, sk, sv = _quant_pools(torch, gen, dev, 2, b * r + 4, kvn,
                                      ps, d)
        sk[:, b * r:b * r + 4] = float("nan")
        sv[:, b * r:b * r + 4] = float("nan")
        return [pk, pv, sk, sv]
    pk = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    pv = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    pk[:, b * r:b * r + 4] = float("nan")
    pv[:, b * r:b * r + 4] = float("nan")
    return [pk, pv]


def _gqa(torch, k, n):
    """[B, kvN, S, D] -> [B, N, S, D] (SDPA takes the heads repeated)."""
    return k if k.shape[1] == n else k.repeat_interleave(n // k.shape[1],
                                                        dim=1)


def check_flash_prefill_window(torch, dev, results, extra):
    """Form 3w against its plain version: the `mistral_window` path's
    whole-prompt dispatch (bench.py's 8 x 128 prompts, Mistral heads,
    window 4096; timed), window 200 across 600 rows, GQA f32 at window 6,
    window 1."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.ops.attention.flash_prefill import (
        flash_prefill_ref, flash_prefill_window)
    gen = torch.Generator(device=dev).manual_seed(41)
    bf, f32 = torch.bfloat16, torch.float32
    cases = {"mistral-7b bench prompts": (8, 128, 32, 8, 128, bf, WINDOW),
             "window 200": (2, 600, 32, 8, 128, bf, 200),
             "gqa f32 window 6": (2, 100, 32, 4, 64, f32, 6),
             "window 1": (1, 64, 8, 8, 128, bf, 1)}
    for tag, (b, s, n, kvn, d, dtype, w) in cases.items():
        q = torch.randn((b, s, n, d), generator=gen, device=dev, dtype=dtype)
        k = torch.randn((b, s, kvn, d), generator=gen, device=dev,
                        dtype=dtype)
        v = torch.randn((b, s, kvn, d), generator=gen, device=dev,
                        dtype=dtype)
        got = flash_prefill_window(q, k, v, w)
        want = flash_prefill_ref(q, k, v, window=w)
        torch.cuda.synchronize()
        ok, err, share, note = _rounding_rule(torch, got, want)
        print(f"[kernels] flash_prefill_window {tag} (B={b} S={s} N={n} "
              f"kvN={kvn} D={d} window={w}): max|err| {err:.3e} ({note}; "
              f"the worst element at {share:.3f} of its limit)", flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"flash_prefill_window {tag} disagrees: {err}, {share}")
        if "flash_prefill_window" in results:
            continue
        es = q.element_size()
        pairs = sum(min(i + 1, w) for i in range(s))
        nbytes = (2 * b * s * n * d + 2 * b * s * kvn * d) * es
        bms, by = bound_ms(nbytes, 4.0 * b * n * d * pairs,
                           dname(torch, dtype))
        pos = torch.arange(s, device=dev)
        mask = ((pos[None] <= pos[:, None])
                & (pos[None] > pos[:, None] - w))[None, None]
        qt = q.transpose(1, 2)
        kt, vt = (_gqa(torch, x.transpose(1, 2), n) for x in (k, v))
        results["flash_prefill_window"] = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: flash_prefill_window(q, k, v, w)),
            plain_ms=time_ms(torch, lambda: flash_prefill_ref(
                q, k, v, window=w)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)),
            bound_ms=bms, bound_by=by)


def check_paged_decode_window(torch, dev, results, extra):
    """Forms 4w, 4qw, 4vw and 4vqw against their plain versions over ring
    tables: the `mistral_window` path's decode (4 rows at kv_len
    4400-4543, past the ring's 35 x 128 = 4480 tokens, Mistral heads,
    window 4096, R 35; timed, S = 5 for the
    verify forms as spec_tokens 4 gives), window 200 (not a page multiple)
    with kv_lens 150-1000 on both sides of it, and GQA f32 at window 6.
    Every case also runs with the table columns wholly below the oldest
    row's band pointing at NaN pages: the output must stay finite and
    bit-equal to the clean run's, so those pages are never read."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    gen = torch.Generator(device=dev).manual_seed(42)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (lens, n, kvn, d, ps, window, dtype)
    cases = {"mistral-7b decode": ([4400, 4480, 4500, 4543], 32, 8, 128, 128,
                                   WINDOW, bf),
             "window 200": ([150, 200, 201, 640, 1000], 32, 8, 128, 128, 200,
                            bf),
             "gqa f32 window 6": ([3, 7, 40], 32, 4, 64, 16, 6, f32)}
    forms = {(False, 1): "paged_flash_decode_window",
             (True, 1): "paged_flash_decode_int8kv_window",
             (False, 5): "paged_flash_verify_window",
             (True, 5): "paged_flash_verify_int8kv_window"}
    for (quant, s), name in forms.items():
        kern = getattr(pd, name)
        ref = pd.paged_flash_decode_ref if s == 1 else pd.paged_flash_verify_ref
        for tag, (lens, n, kvn, d, ps, w, dtype) in cases.items():
            b = len(lens)
            # the path's ring (sized for its 256-row chunks) at window 4096
            r = MISTRAL_RING if w == WINDOW else (w + s - 2) // ps + 2
            mp = -(-max(lens) // ps)
            pools = _ring_pools(torch, gen, dev, b, r, kvn, ps, d, dtype,
                                quant)
            scales = pools[2:] if quant else []
            clean = _ring_tables(torch, dev, b, r, mp)
            kv = torch.tensor(lens, dtype=torch.int32, device=dev)
            dirty = _poisoned(torch, clean, kv - s - w + 1, ps, b * r)
            q = torch.randn((b, s, n, d), generator=gen, device=dev,
                            dtype=dtype)
            qq = q[:, 0] if s == 1 else q

            def run(tb, _q=qq, _p=pools, _kv=kv, _w=w, _sc=scales):
                return kern(_q, _p[0], _p[1], *_sc, tb, _kv, 1, _w)

            got, got_clean = run(dirty), run(clean)
            kw = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
            want = ref(qq, pools[0], pools[1], clean, kv, 1, window=w, **kw)
            torch.cuda.synchronize()
            ok, err, share, note = _rounding_rule(torch, got, want)
            same = bool(torch.equal(got, got_clean))
            print(f"[kernels] {name} {tag} (B={b} S={s} N={n} kvN={kvn} "
                  f"D={d} window={w} R={r}): max|err| {err:.3e} ({note}; "
                  f"the worst element at {share:.3f} of its limit); NaN "
                  f"pages below the band: finite "
                  f"{bool(torch.isfinite(got).all())}, output unchanged "
                  f"{same}", flush=True)
            require(bool(torch.isfinite(got).all()) and same and ok,
                    f"{name} {tag} disagrees: {err}, {share}, unchanged "
                    f"{same}")
            if name in results:
                continue
            # what these inputs need: each row's keys in its band
            es = q.element_size()
            band = [min(ln, w + s - 1) for ln in lens]
            keys = sum(min(ln - s + j + 1, w) for ln in lens
                       for j in range(s))
            kvb = (d + 4) if quant else d * es
            nbytes = (2 * b * s * n * d * es + 2 * sum(band) * kvn * kvb
                      + clean.numel() * 4 + b * 4)
            bms, by = bound_ms(nbytes, 4.0 * n * d * keys,
                               dname(torch, dtype))
            gk = [pools[0][1], pools[1][1]]
            if quant:
                gk += [pools[2][1], pools[3][1]]
            ck, cv = gather_dense(gk[0], gk[1], clean,
                                  *(gk[2:] if quant else []))
            if quant:
                ck, cv = ck.to(dtype), cv.to(dtype)
            key_pos = torch.arange(ck.shape[2], device=dev)
            q_pos = (kv.long()[:, None] - s
                     + torch.arange(s, device=dev)[None])
            mask = ((key_pos[None, None] <= q_pos[:, :, None])
                    & (key_pos[None, None] > q_pos[:, :, None] - w))[:, None]
            qt = q.transpose(1, 2)
            ck4, cv4 = _gqa(torch, ck, n), _gqa(torch, cv, n)
            kw_ = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
            results[name] = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: run(clean)),
                plain_ms=time_ms(torch, lambda: ref(
                    qq, pools[0], pools[1], clean, kv, 1, window=w, **kw_)),
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, ck4, cv4, attn_mask=mask)),
                bound_ms=bms, bound_by=by,
                library=LIBRARY[name] + (" (gather and dequant outside the "
                                         "timing)" if quant else ""))


def check_paged_prefill_window(torch, dev, results, extra):
    """Forms 8w and 8qw against their plain versions over ring tables: the
    `mistral_window` path's chunks (256 rows at offset 3840, kv_len 4096,
    and the last, 128 live rows at offset 4096; Mistral heads, window
    4096, R 35; timed), window 200 with two sequences at offsets 256 and
    512, and GQA f32 at window 6, each also over NaN pages below the band
    (the output must stay finite and unchanged)."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops.attention import paged_prefill as pp
    gen = torch.Generator(device=dev).manual_seed(43)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (sq, offsets, kv_lens, n, kvn, d, ps, window, dtype)
    cases = {
        "mistral-7b chunk": (MISTRAL_CHUNK, [3840], [4096], 32, 8, 128, 128,
                             WINDOW, bf),
        "mistral-7b last chunk": (MISTRAL_CHUNK, [4096], [4224], 32, 8, 128,
                                  128, WINDOW, bf),
        "window 200": (256, [256, 512], [512, 612], 32, 8, 128, 128, 200,
                       bf),
        "gqa f32 window 6": (32, [16, 48], [48, 70], 32, 4, 64, 16, 6, f32),
    }
    for quant, name in ((False, "paged_flash_prefill_window"),
                        (True, "paged_flash_prefill_int8kv_window")):
        kern = getattr(pp, name)
        for tag, (sq, offs, lens, n, kvn, d, ps, w, dtype) in cases.items():
            b = len(offs)
            r = (w + max(sq, 128) - 2) // ps + 2
            mp = -(-max(o + sq for o in offs) // ps)
            pools = _ring_pools(torch, gen, dev, b, r, kvn, ps, d, dtype,
                                quant)
            scales = pools[2:] if quant else []
            clean = _ring_tables(torch, dev, b, r, mp)
            off_t = torch.tensor(offs, dtype=torch.int32, device=dev)
            kv = torch.tensor(lens, dtype=torch.int32, device=dev)
            dirty = _poisoned(torch, clean, off_t - w + 1, ps, b * r)
            q = torch.randn((b, sq, n, d), generator=gen, device=dev,
                            dtype=dtype)

            def run(tb, _q=q, _p=pools, _kv=kv, _o=off_t, _w=w, _sc=scales):
                return kern(_q, _p[0], _p[1], *_sc, tb, _kv, _o, 1, _w)

            got, got_clean = run(dirty), run(clean)
            kw = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
            want = pp.paged_flash_prefill_ref(q, pools[0], pools[1], clean,
                                              kv, off_t, 1, window=w, **kw)
            torch.cuda.synchronize()
            live = [ln - o for o, ln in zip(offs, lens)]
            ok, err, share, note = _rounding_rule(
                torch, torch.cat([got[i, :lv].reshape(-1)
                                  for i, lv in enumerate(live)]),
                torch.cat([want[i, :lv].reshape(-1)
                           for i, lv in enumerate(live)]))
            same = bool(torch.equal(got, got_clean))
            print(f"[kernels] {name} {tag} (B={b} Sq={sq} N={n} kvN={kvn} "
                  f"D={d} window={w} R={r}): max|err| {err:.3e} ({note}; "
                  f"the worst element at {share:.3f} of its limit); NaN "
                  f"pages below the band: finite "
                  f"{bool(torch.isfinite(got).all())}, output unchanged "
                  f"{same}", flush=True)
            require(bool(torch.isfinite(got).all()) and same and ok,
                    f"{name} {tag} disagrees: {err}, {share}, unchanged "
                    f"{same}")
            if not tag.startswith("mistral"):
                continue
            es = q.element_size()
            keys = sum(min(o + i + 1, ln) - max(0, o + i - w + 1)
                       for o, ln in zip(offs, lens) for i in range(sq)
                       if o + i < ln)
            rows = sum(min(ln, o + sq) - max(0, o - w + 1)
                       for o, ln in zip(offs, lens))
            kvb = (d + 4) if quant else d * es
            nbytes = (2 * b * sq * n * d * es + 2 * rows * kvn * kvb
                      + clean.numel() * 4 + 2 * b * 4)
            bms, by = bound_ms(nbytes, 4.0 * n * d * keys,
                               dname(torch, dtype))
            gk = [pools[0][1], pools[1][1]]
            if quant:
                gk += [pools[2][1], pools[3][1]]
            ck, cv = gather_dense(gk[0], gk[1], clean,
                                  *(gk[2:] if quant else []))
            if quant:
                ck, cv = ck.to(dtype), cv.to(dtype)
            key_pos = torch.arange(ck.shape[2], device=dev)
            q_pos = (off_t.long()[:, None]
                     + torch.arange(sq, device=dev)[None])
            mask = ((key_pos[None, None] <= q_pos[:, :, None])
                    & (key_pos[None, None] > q_pos[:, :, None] - w)
                    & (key_pos[None, None] < kv.long()[:, None, None]))
            mask = mask[:, None]
            qt = q.transpose(1, 2)
            ck4, cv4 = _gqa(torch, ck, n), _gqa(torch, cv, n)
            res = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: run(clean)),
                plain_ms=time_ms(torch, lambda: pp.paged_flash_prefill_ref(
                    q, pools[0], pools[1], clean, kv, off_t, 1, window=w,
                    **kw)),
                library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, ck4, cv4, attn_mask=mask)),
                bound_ms=bms, bound_by=by,
                library=LIBRARY[name] + (" (gather and dequant outside the "
                                         "timing)" if quant else ""))
            extra.append((name, tag, res))
            results.setdefault(name, res)


def check_fused_qkv_kv_layer(torch, dev, results, extra):
    """Form 6k against its plain version: the `mistral_window` path's
    decode call (4 rows, Mistral's H 4096 and 32/8 heads, ring pools of R
    35, weights of layer 1 writing pool layer 0), and GQA f32 with an
    unmapped row (its write goes to the trash page)."""
    from simplellminference_tpu_torch.ops import qkv_fused as qf
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.qkv_fused import (
        fused_qkv_append_kv_layer, fused_qkv_append_ref)
    gen = torch.Generator(device=dev).manual_seed(44)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (b, h, n, kvn, d, dtype, positions); every bf16 case is timed on
    # 6m and on the FMA kernel, the first also over weight copies past the
    # L2 (the pool layer stays kv_layer)
    cases = {"mistral-7b decode": (4, 4096, 32, 8, 128, bf,
                                   [4400, 4480, 4500, 4542]),
             "mistral-7b m1": (1, 4096, 32, 8, 128, bf, [4479]),
             "tinyllama-gqa f32": (5, 2048, 32, 4, 64, f32,
                                   [3, 150, 4000, 300, 1000]),
             "tinyllama-gqa bf16": (5, 2048, 32, 4, 64, bf,
                                    [3, 150, 4000, 300, 1000])}
    layer, kv_layer = 1, 0
    for tag, (b, h, n, kvn, d, xdt, plist) in cases.items():
        ps = 128
        r = MISTRAL_RING
        mp = -(-(max(plist) + 1) // ps)
        nq = (n + 2 * kvn) * d
        wq, ws = _qweight(torch, gen, dev, (2, h, nq), 1)
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(xdt)
        x = torch.randn((b, h), generator=gen, device=dev).to(xdt)
        pk, pv = _pools(torch, gen, dev, 2, b * r, kvn, ps, d, xdt)
        tables = _ring_tables(torch, dev, b, r, mp)
        if tag.startswith("tinyllama"):
            tables[2] = -1              # a dead row: its write goes to trash
        pos = torch.tensor(plist, dtype=torch.int32, device=dev)
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        a, rr = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
        qa, *_ = fused_qkv_append_kv_layer(x, nw, wq, ws, sin, cos, *a,
                                           layer, kv_layer, pos, tables,
                                           n_heads=n, kv_heads=kvn)
        qr, *_ = fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *rr, layer,
                                      pos, n_heads=n, kv_heads=kvn,
                                      tables=tables, kv_layer=kv_layer)
        torch.cuda.synchronize()
        page = tables.long()[torch.arange(b, device=dev), pos.long() // ps]
        page = torch.where(page >= 0, page, pk.shape[1] - 1)
        written = torch.zeros(pk.shape, dtype=torch.bool, device=dev)
        written[kv_layer, page, :, pos.long() % ps] = True
        err = max_err(qa, qr)
        kv_err = max(max_err(ta[written], tr[written])
                     for ta, tr in zip(a, rr))
        untouched = all(torch.equal(ta[~written], tr[~written])
                        for ta, tr in zip(a, rr))
        if xdt == f32:
            lim_q = F32_REL * float(qr.abs().max())
            lim_kv = F32_REL * max(float(tr[written].abs().max())
                                   for tr in rr)
        else:
            lim_q = TOL["bfloat16"] * float(qr.float().std())
            lim_kv = TOL["bfloat16"] * max(float(tr[written].float().std())
                                           for tr in rr)
        regime = qf.qkv_regime(b, h, nq, d, xdt)
        print(f"[kernels] fused_qkv_append_kv_layer {tag} ({regime}; layer "
              f"{layer}, pool layer {kv_layer}): q max|err| {err:.3e} (tol "
              f"{lim_q:.3e}); k/v rows {kv_err:.3e} (tol {lim_kv:.3e}); "
              f"other pool entries (layer {layer} included) equal: "
              f"{untouched}", flush=True)
        require(bool(torch.isfinite(qa).all()) and err <= lim_q
                and kv_err <= lim_kv and untouched,
                f"fused_qkv_append_kv_layer {tag} disagrees: {err}, "
                f"{kv_err}, {untouched}")
        if regime != "mma":
            continue
        nbytes = _qkv_nbytes(h, nq, b, n, kvn, d, x.element_size(),
                             nw.element_size(), d * pk.element_size(),
                             tables.numel() * 4 + b * 4)
        qt, st = _int8pack(torch, wq[layer], ws[layer], xdt)
        cold = None
        if tag == "mistral-7b decode":
            copies = max(2, int(2 * L2_BYTES // (h * nq)) + 1)
            wc, sc = _qweight(torch, gen, dev, (copies, h, nq), 1)
            nwc = nw[layer].expand(copies, h).contiguous()
            cold = _rotating(lambda li: fused_qkv_append_kv_layer(
                x, nwc, wc, sc, sin, cos, *a, li, kv_layer, pos, tables,
                n_heads=n, kv_heads=kvn), copies)
        _time_qkv(torch, "fused_qkv_append_kv_layer", tag,
                  lambda: fused_qkv_append_kv_layer(
                      x, nw, wq, ws, sin, cos, *a, layer, kv_layer, pos,
                      tables, n_heads=n, kv_heads=kvn),
                  lambda: fused_qkv_append_ref(
                      x, nw, wq, ws, sin, cos, *rr, layer, pos, n_heads=n,
                      kv_heads=kvn, tables=tables, kv_layer=kv_layer),
                  qr, nbytes, 2.0 * b * h * nq, dname(torch, xdt),
                  (x, qt, st), results, extra, max(err, kv_err), cold)


def check_fused_wo_ffn(torch, dev, results, extra):
    """Kernel 16 against its plain version (the wo product rounded, the
    residual, the plain FFN) at Llama-2-7B and Mistral-7B widths, m = 8
    (timed), TinyLlama width in f32 (m 3) and bf16 (m 40), and a small
    grid; a grid past what the card holds at once must raise."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.ops.ffn_fused import (
        _fused_wo_ffn_launch, fused_wo_ffn, fused_wo_ffn_ref, wo_ffn_max_grid)
    gen = torch.Generator(device=dev).manual_seed(45)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (m, N*D, H, I, dtype, grid)
    cases = {"llama2-7b": (8, 4096, 4096, 11008, bf, None),
             "mistral-7b": (8, 4096, 4096, 14336, bf, None),
             "tinyllama f32 m3": (3, 2048, 2048, 5632, f32, None),
             "tinyllama m40 grid 5": (40, 2048, 2048, 5632, bf, 5)}
    for tag, (m, nd, h, inter, xdt, grid) in cases.items():
        layer = 1
        wq, ws = _qweight(torch, gen, dev, (2, nd, h), 1)
        q1, s1 = _qweight(torch, gen, dev, (2, h, 2 * inter), 1)
        q2, s2 = _qweight(torch, gen, dev, (2, inter, h), 1)
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(xdt)
        attn = torch.randn((m, nd), generator=gen, device=dev).to(xdt)
        x = torch.randn((m, h), generator=gen, device=dev).to(xdt)
        args = (attn, x, wq, ws, nw, q1, s1, q2, s2, layer)
        most = wo_ffn_max_grid(xdt)
        got = (fused_wo_ffn(*args) if grid is None
               else _fused_wo_ffn_launch(*args, 1e-5, grid))
        want = fused_wo_ffn_ref(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        lim = (F32_REL * float(want.abs().max()) if xdt == f32
               else TOL["bfloat16"] * float(want.float().std()))
        try:
            _fused_wo_ffn_launch(*args, 1e-5, most + 1)
            refused = False
        except RuntimeError:
            refused = True
        print(f"[kernels] fused_wo_ffn {tag} (m={m} N*D={nd} H={h} I={inter}"
              f", grid {grid or most} of {most}): max|err| {err:.3e} (tol "
              f"{lim:.3e}); a grid of {most + 1} refused: {refused}",
              flush=True)
        require(bool(torch.isfinite(got).all()) and err <= lim and refused,
                f"fused_wo_ffn {tag} disagrees: {err}, refused {refused}")
        if m != 8:
            continue
        es = x.element_size()
        wbytes = nd * h + 3 * h * inter
        nbytes = (wbytes + (2 * h + 2 * inter) * 4 + m * nd * es
                  + 2 * m * h * es + h * nw.element_size())
        bms, by = bound_ms(nbytes, 2.0 * m * wbytes, dname(torch, xdt))
        pk0 = _int8pack(torch, wq[layer], ws[layer], xdt)
        pk1 = _int8pack(torch, q1[layer], s1[layer], xdt)
        pk2 = _int8pack(torch, q2[layer], s2[layer], xdt)
        nwl = nw[layer]

        def library():
            xr = x + torch._weight_int8pack_mm(attn, *pk0)
            xf = xr.float()
            xn = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5)
                  * nwl.float()).to(xdt)
            gu = torch._weight_int8pack_mm(xn, *pk1)
            hh = F.silu(gu[:, :inter]) * gu[:, inter:]
            return xr + torch._weight_int8pack_mm(hh, *pk2)

        res = dict(max_abs_err=err, ms=time_ms(torch, lambda: fused_wo_ffn(
                       *args)),
                   plain_ms=time_ms(torch, lambda: fused_wo_ffn_ref(*args)),
                   library_ms=time_ms(torch, library),
                   bound_ms=bms, bound_by=by)
        extra.append(("fused_wo_ffn", tag, res))
        results.setdefault("fused_wo_ffn", res)


def check_flash_decode_dyn(torch, dev, results, extra):
    """Kernel 17 against its plain version at the `dense` path's arena
    (Llama-2-7B: 8 rows, 32 kv heads, Smax 1024, D 128, bf16, kv_len
    ~150; timed at bk 256, the TPU's default, and checked at bk 128 too,
    equal), GQA in f32 with kv_len 0, 1, a tile edge and Smax, and a 4-D
    cache with more rows than sequences."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.ops.attention.flash_decode_dyn import (
        flash_decode_dyn, flash_decode_dyn_ref)
    gen = torch.Generator(device=dev).manual_seed(46)
    bf, f32 = torch.bfloat16, torch.float32
    # tag: (layers, B, arena rows, N, kvN, Smax, dtype, kv_lens)
    cases = {"llama2-7b dense arena": (2, 8, 8, 32, 32, 1024, bf,
                                       [145 + 2 * i for i in range(8)]),
             "gqa f32 edges": (2, 6, 6, 32, 8, 512, f32,
                               [0, 1, 31, 32, 300, 512]),
             "4-d, rows < arena": (1, 3, 5, 32, 8, 256, bf, [10, 0, 256])}
    for tag, (nl, b, rows, n, kvn, smax, dtype, lens) in cases.items():
        d = 128
        ck, cv = _arena(torch, gen, dev, nl, rows, kvn, smax, d, dtype)
        q = torch.randn((b, n, d), generator=gen, device=dev, dtype=dtype)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        if nl == 1:
            ck, cv, layer = ck[0], cv[0], None
        else:
            layer = nl - 1
        got = flash_decode_dyn(q, ck, cv, kv, bk=256, layer=layer)
        got128 = flash_decode_dyn(q, ck, cv, kv, bk=128, layer=layer)
        want = flash_decode_dyn_ref(q, ck, cv, kv, layer=layer)
        torch.cuda.synchronize()
        ok, err, share, note = _rounding_rule(torch, got, want)
        zero = all(bool((got[i] == 0).all()) for i in range(b)
                   if lens[i] == 0)
        same = bool(torch.equal(got, got128))
        print(f"[kernels] flash_decode_dyn {tag} (B={b} N={n} kvN={kvn} "
              f"D={d} Smax={smax}): max|err| {err:.3e} ({note}; the worst "
              f"element at {share:.3f} of its limit); kv_len 0 rows zero: "
              f"{zero}; bk 128 == bk 256: {same}", flush=True)
        require(bool(torch.isfinite(got).all()) and ok and zero and same,
                f"flash_decode_dyn {tag} disagrees: {err}, {share}, zero "
                f"rows {zero}, bk-equal {same}")
        if "flash_decode_dyn" in results:
            continue
        live = sum(min(ln, smax) for ln in lens)
        es = q.element_size()
        nbytes = 2 * b * n * d * es + 2 * live * kvn * d * es + b * 4
        bms, by = bound_ms(nbytes, 4.0 * n * d * live, dname(torch, dtype))
        top = max(lens)
        k4, v4 = ck[layer, :b, :, :top], cv[layer, :b, :, :top]
        mask = (torch.arange(top, device=dev)[None, None, None, :]
                < kv.long()[:, None, None, None])
        q4 = q[:, :, None]
        k4, v4 = _gqa(torch, k4, n), _gqa(torch, v4, n)
        results["flash_decode_dyn"] = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: flash_decode_dyn(q, ck, cv, kv,
                                                       layer=layer)),
            plain_ms=time_ms(torch, lambda: flash_decode_dyn_ref(
                q, ck, cv, kv, layer=layer)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask)),
            bound_ms=bms, bound_by=by)


# ------------------------------------------------- head_dim 256 (Gemma-2B)

GEMMA = dict(h=2048, n=8, kvn=1, d=256)   # ModelConfig.gemma_2b's attention


def check_head_dim_256(torch, dev, results, extra):
    """The D-256 forms at Gemma-2B's shapes (8 q heads over one kv head, D
    256, page 128, batch 8): the writes 1 and 2 byte-exact (bf16 rows of
    512 bytes, the 16-byte path); 3 at bench.py's prefill (8 x 128, the
    row), a 1000-row prompt whose key walk splits and f32; 4 at the decode
    context (kv_len 128-156, the row), f32 with a dead slot, the split
    edges and kv_len 4096; 13 over a dense arena (bf16, the row, and f32
    edge lens); 8 at `gemma_prefix`'s dispatches (8 x 64 suffix rows
    behind 512 cached tokens, the row; a 256-row chunk at offset 256) and
    f32 with ragged offsets, an unmapped page and a padding row, all by
    the attention rules; 6 at the decode (8 rows, 6m: q by the fused
    rule, k/v rows likewise, every other pool byte equal; timed beside
    the FMA kernel forced on the same inputs), with an unmapped row, 1
    row, f32 rows (the FMA kernel) and the dense arena (6d). Then sinks
    at D 256 (4s, 4es, 4ves, 8es), which no model has, must raise before
    any launch."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops import paged_append as pa
    from simplellminference_tpu_torch.ops import qkv_fused as qf
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    from simplellminference_tpu_torch.ops.attention import flash_prefill as fp
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    from simplellminference_tpu_torch.ops.attention import paged_prefill as pp
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(256)
    bf, f32 = torch.bfloat16, torch.float32
    h, n, kvn, d = GEMMA["h"], GEMMA["n"], GEMMA["kvn"], GEMMA["d"]
    b, ps, layer = 8, 128, 1

    # 1 and 2: byte-exact, timed at the decode write and bench.py's prompt
    for dtype in (bf, f32):
        s, mp = 128, 3
        pk, pv = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, dtype)
        qkv = torch.randn((b, s, 3 * kvn * d), generator=gen, device=dev,
                          dtype=dtype)
        nk = qkv[..., kvn * d:2 * kvn * d].reshape(b, s, kvn, d)
        nv = qkv[..., 2 * kvn * d:].reshape(b, s, kvn, d)   # strided views
        tables = _tables(torch, dev, b, mp)
        pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
        a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
        pa.paged_append_prefill(*a, nk, nv, tables, 0)
        pa.paged_append_prefill_ref(*r, nk, nv, tables, 0)
        pa.paged_append_decode(*a, nk[:, 0], nv[:, 0], tables, pos, layer)
        pa.paged_append_decode_ref(*r, nk[:, 0], nv[:, 0], tables, pos,
                                   layer)
        torch.cuda.synchronize()
        err = max(max_err(x[:, :-1], y[:, :-1]) for x, y in zip(a, r))
        print(f"[kernels] paged_append_prefill + paged_append_decode "
              f"gemma-2b d256 {dname(torch, dtype)}: max|err| {err} (tol 0, "
              f"exact; trash page excluded)", flush=True)
        require(err == 0.0, f"paged_append d256 {dtype} disagrees: {err}")
        if dtype != bf:
            continue
        es = pk.element_size()
        p1 = pk.shape[1]
        col = tables.long().gather(1, (pos.long() // ps)[:, None])[:, 0]
        page = torch.where(col >= 0, col, p1 - 1)
        slot, heads = pos.long() % ps, torch.arange(kvn, device=dev)
        k0, v0 = nk[:, 0].contiguous(), nv[:, 0].contiguous()

        def put():
            a[0][layer].index_put_((page[:, None], heads[None],
                                    slot[:, None]), k0)
            a[1][layer].index_put_((page[:, None], heads[None],
                                    slot[:, None]), v0)

        nbytes = 2 * b * kvn * d * es * 2 + tables.numel() * 4 + b * 4
        bms, by = bound_ms(nbytes, 0.0, "bfloat16")
        extra.append(("paged_append_decode", "gemma-2b d256", dict(
            max_abs_err=err, ms=time_ms(torch, lambda: pa.paged_append_decode(
                *a, nk[:, 0], nv[:, 0], tables, pos, layer)),
            plain_ms=time_ms(torch, lambda: pa.paged_append_decode_ref(
                *r, nk[:, 0], nv[:, 0], tables, pos, layer)),
            library_ms=time_ms(torch, put), bound_ms=bms, bound_by=by)))
        idx = torch.where(tables[:, 0] >= 0, tables[:, 0].long(), p1 - 1)
        ck = nk.permute(0, 2, 1, 3).contiguous()
        cv = nv.permute(0, 2, 1, 3).contiguous()

        def copy():
            a[0][0].index_copy_(0, idx, ck)
            a[1][0].index_copy_(0, idx, cv)

        nbytes = 2 * 2 * b * s * kvn * d * es + tables.numel() * 4
        bms, by = bound_ms(nbytes, 0.0, "bfloat16")
        extra.append(("paged_append_prefill", "gemma-2b d256", dict(
            max_abs_err=err, ms=time_ms(torch, lambda: pa.paged_append_prefill(
                *a, nk, nv, tables, 0)),
            plain_ms=time_ms(torch, lambda: pa.paged_append_prefill_ref(
                *r, nk, nv, tables, 0)),
            library_ms=time_ms(torch, copy), bound_ms=bms, bound_by=by)))

    # 3: (B, S, dtype); the first timed, the row
    for tag, (bb, s, dtype) in {"gemma-2b": (8, 128, bf),
                                "gemma-2b split walk": (1, 1000, bf),
                                "gemma-2b f32": (2, 100, f32)}.items():
        q = torch.randn((bb, s, n, d), generator=gen, device=dev,
                        dtype=dtype)
        big = torch.randn((bb, s, (n + 2 * kvn) * d), generator=gen,
                          device=dev, dtype=dtype)
        k = big[..., n * d:(n + kvn) * d].reshape(bb, s, kvn, d)
        v = big[..., (n + kvn) * d:].reshape(bb, s, kvn, d)
        got = fp.flash_prefill(q, k, v)
        want = fp.flash_prefill_ref(q, k, v)
        torch.cuda.synchronize()
        ok, err, note = _prefill_rule(torch, got, want)
        print(f"[kernels] flash_prefill d256 {tag} (B={bb} S={s}): max|err| "
              f"{err:.3e} ({note})", flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"flash_prefill d256 {tag} disagrees: {err} ({note})")
        if tag != "gemma-2b":
            continue
        qt = q.transpose(1, 2)
        kt = _gqa(torch, k.transpose(1, 2), n).contiguous()
        vt = _gqa(torch, v.transpose(1, 2), n).contiguous()
        es = q.element_size()
        nbytes = (2 * bb * s * n * d + 2 * bb * s * kvn * d) * es
        bms, by = bound_ms(nbytes, 4.0 * bb * n * d * s * (s + 1) / 2,
                           "bfloat16")
        results["flash_prefill_d256"] = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: fp.flash_prefill(
                q, k, v)),
            plain_ms=time_ms(torch, lambda: fp.flash_prefill_ref(q, k, v)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            bound_ms=bms, bound_by=by)

    # 4: (dtype, kv_lens, table columns, dead slot)
    cases = {
        "gemma-2b": (bf, [128 + 4 * i for i in range(8)], 2, False),
        "gemma-2b f32": (f32, [1, 5, 128, 200, 0, 129, 150, 33], 2, True),
        "gemma-2b kv_len 4096": (bf, [4096] * 8, 32, False),
    }
    for i, lens in enumerate(_split_edge_lens(kvn, 2048, rows=n)):
        cases[f"gemma-2b split edges {i}"] = (bf, lens, 16, True)
    for tag, (dtype, lens, mp, dead) in cases.items():
        bb = len(lens)
        pk, pv = _pools(torch, gen, dev, 2, bb * mp, kvn, ps, d, dtype)
        q = torch.randn((bb, n, d), generator=gen, device=dev, dtype=dtype)
        tables = _tables(torch, dev, bb, mp, dead_last=dead)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = pd.paged_flash_decode(q, pk, pv, tables, kv_lens, layer)
        want = pd.paged_flash_decode_ref(q, pk, pv, tables, kv_lens, layer)
        torch.cuda.synchronize()
        zero = [i for i in range(bb) if lens[i] == 0] + [bb - 1] * dead
        err = _attn_check(torch, "paged_flash_decode d256", tag, got, want,
                          zero)
        if tag not in ("gemma-2b", "gemma-2b kv_len 4096"):
            continue
        ck, cv = gather_dense(pk[layer], pv[layer], tables)
        ck, cv = _gqa(torch, ck, n), _gqa(torch, cv, n)
        mask = (torch.arange(ck.shape[2], device=dev)[None, None, None, :]
                < kv_lens.long()[:, None, None, None])
        es = q.element_size()
        kvb, live = _decode_bytes(torch, tables, kv_lens, ps,
                                  2 * kvn * d * es)
        nbytes = 2 * bb * n * d * es + kvb + tables.numel() * 4 + bb * 4
        bms, by = bound_ms(nbytes, 4.0 * n * d * live, "bfloat16")
        res = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: pd.paged_flash_decode(
                q, pk, pv, tables, kv_lens, layer)),
            plain_ms=time_ms(torch, lambda: pd.paged_flash_decode_ref(
                q, pk, pv, tables, kv_lens, layer)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], ck, cv, attn_mask=mask)),
            bound_ms=bms, bound_by=by)
        extra.append(("paged_flash_decode_d256", tag, res))
        results.setdefault("paged_flash_decode_d256", res)
        del ck, cv

    # 13: the dense arena (layers 2, 8 rows, Smax 1024)
    for tag, (dtype, lens) in {
            "gemma-2b": (bf, [145 + 2 * i for i in range(8)]),
            "gemma-2b f32 edge lens": (f32, [0, 1, 161, 1023, 1024, 1030, 64,
                                             65])}.items():
        smax = 1024
        ck, cv = _arena(torch, gen, dev, 2, b, kvn, smax, d, dtype)
        q = torch.randn((b, n, d), generator=gen, device=dev, dtype=dtype)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = fd.flash_decode(q, ck, cv, kv_lens, layer=layer)
        want = fd.flash_decode_ref(q, ck, cv, kv_lens, layer=layer)
        torch.cuda.synchronize()
        err = _attn_check(torch, "flash_decode d256", tag, got, want,
                          [i for i in range(b) if lens[i] <= 0])
        if tag != "gemma-2b":
            continue
        top = max(lens)
        k4 = _gqa(torch, ck[layer, :, :, :top], n)
        v4 = _gqa(torch, cv[layer, :, :, :top], n)
        mask = (torch.arange(top, device=dev)[None, None, None, :]
                < kv_lens.long()[:, None, None, None])
        live = sum(min(ln, smax) for ln in lens)
        es = q.element_size()
        nbytes = 2 * b * n * d * es + 2 * live * kvn * d * es + b * 4
        bms, by = bound_ms(nbytes, 4.0 * n * d * live, "bfloat16")
        results["flash_decode_d256"] = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: fd.flash_decode(
                q, ck, cv, kv_lens, layer=layer)),
            plain_ms=time_ms(torch, lambda: fd.flash_decode_ref(
                q, ck, cv, kv_lens, layer=layer)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], k4, v4, attn_mask=mask)),
            bound_ms=bms, bound_by=by)

    # 8: (Sq, page, offsets, kv_lens, dtype, unmapped entries)
    cases = {
        "gemma-2b suffix batch": (64, 128, [512] * 8,
                                  [540 + 5 * i for i in range(8)], bf, False),
        "gemma-2b chunk": (256, 128, [256], [512], bf, False),
        "gemma-2b f32": (100, 16, [0, 48, 16, 0], [100, 130, 77, 1], f32,
                         True),
    }
    for tag, (sq, pss, offs, lens, dtype, unmapped) in cases.items():
        bb = len(offs)
        mp = -(-max(o + sq for o in offs) // pss)
        pk, pv = _pools(torch, gen, dev, 2, bb * mp, kvn, pss, d, dtype)
        tables = _tables(torch, dev, bb, mp, dead_last=unmapped)
        if unmapped:
            tables[2, 1] = -1           # inside row 2's kv_len
        q = torch.randn((bb, sq, n, d), generator=gen, device=dev,
                        dtype=dtype)
        off_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        kv_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = pp.paged_flash_prefill(q, pk, pv, tables, kv_t, off_t, layer)
        want = pp.paged_flash_prefill_ref(q, pk, pv, tables, kv_t, off_t,
                                          layer)
        torch.cuda.synchronize()
        ok, err, note = _prefill_rule(torch, got, want)
        print(f"[kernels] paged_flash_prefill d256 {tag} (B={bb} Sq={sq} "
              f"ps={pss}): max|err| {err:.3e} ({note})", flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"paged_flash_prefill d256 {tag} disagrees: {err} ({note})")
        if dtype != bf:
            continue
        es = q.element_size()
        keys = sum(min(o + rr + 1, ln) for o, ln in zip(offs, lens)
                   for rr in range(sq))
        kv_rows = sum(min(ln, o + sq) for o, ln in zip(offs, lens))
        nbytes = (2 * bb * sq * n * d * es + 2 * kv_rows * kvn * d * es
                  + tables.numel() * 4 + 2 * bb * 4)
        bms, by = bound_ms(nbytes, 4.0 * n * d * keys, "bfloat16")
        ck, cv = gather_dense(pk[layer], pv[layer], tables)
        ck, cv = _gqa(torch, ck, n), _gqa(torch, cv, n)
        key_pos = torch.arange(ck.shape[2], device=dev)
        q_pos = off_t.long()[:, None] + torch.arange(sq, device=dev)[None]
        mask = ((key_pos[None, None] <= q_pos[:, :, None])
                & (key_pos[None, None] < kv_t.long()[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        res = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: pp.paged_flash_prefill(
                q, pk, pv, tables, kv_t, off_t, layer)),
            plain_ms=time_ms(torch, lambda: pp.paged_flash_prefill_ref(
                q, pk, pv, tables, kv_t, off_t, layer)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, ck, cv, attn_mask=mask)),
            bound_ms=bms, bound_by=by)
        extra.append(("paged_flash_prefill_d256", tag, res))
        results.setdefault("paged_flash_prefill_d256", res)
        del ck, cv

    # 6 (6m for bf16 rows, the FMA kernel for f32) and 6d: (rows, dtype,
    # unmapped row, dense arena)
    nq = (n + 2 * kvn) * d
    for tag, (bb, dtype, unmapped, dense) in {
            "gemma-2b": (8, bf, False, False),
            "gemma-2b unmapped row": (8, bf, True, False),
            "gemma-2b m1": (1, bf, False, False),
            "gemma-2b f32": (8, f32, True, False),
            "gemma-2b dense": (8, bf, False, True)}.items():
        wq, ws = _qweight(torch, gen, dev, (2, h, nq), 1)
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(dtype)
        x = torch.randn((bb, h), generator=gen, device=dev).to(dtype)
        pos = (128 + 4 * torch.arange(bb, device=dev)).to(torch.int32)
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        mp = 3
        if dense:
            pk, pv = _arena(torch, gen, dev, 2, bb, kvn, 1024, d, dtype)
            tables, kw = None, {}
        else:
            pk, pv = _pools(torch, gen, dev, 2, bb * mp, kvn, ps, d, dtype)
            tables = _tables(torch, dev, bb, mp, dead_last=False)
            if unmapped:
                tables[-1, int(pos[-1]) // ps] = -1
            kw = dict(tables=tables)
        a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
        qa, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, *a, layer,
                                     pos, n_heads=n, kv_heads=kvn, **kw)
        qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, layer,
                                         pos, n_heads=n, kv_heads=kvn, **kw)
        torch.cuda.synchronize()
        written = torch.zeros(pk.shape, dtype=torch.bool, device=dev)
        if dense:
            written[layer, torch.arange(bb, device=dev), :,
                    pos.long()] = True
        else:
            page = tables.long()[torch.arange(bb, device=dev),
                                 pos.long() // ps]
            page = torch.where(page >= 0, page, pk.shape[1] - 1)
            written[layer, page, :, pos.long() % ps] = True
        err = max_err(qa, qr)
        kv_err = max(max_err(ta[written], tr[written])
                     for ta, tr in zip(a, r))
        untouched = all(torch.equal(ta[~written], tr[~written])
                        for ta, tr in zip(a, r))
        if dtype == f32:
            lim_q = F32_REL * float(qr.abs().max())
            lim_kv = F32_REL * max(float(tr[written].abs().max())
                                   for tr in r)
        else:
            lim_q = TOL["bfloat16"] * float(qr.float().std())
            lim_kv = TOL["bfloat16"] * max(float(tr[written].float().std())
                                           for tr in r)
        regime = qf.qkv_regime(bb, h, nq, d, dtype)
        print(f"[kernels] fused_qkv_append d256 {tag} ({regime}): q "
              f"max|err| {err:.3e} (tol {lim_q:.3e}); k/v rows {kv_err:.3e} "
              f"(tol {lim_kv:.3e}); other pool entries equal: {untouched}",
              flush=True)
        require(bool(torch.isfinite(qa).all()) and err <= lim_q
                and kv_err <= lim_kv and untouched,
                f"fused_qkv_append d256 {tag} disagrees: {err}, {kv_err}, "
                f"{untouched}")
        if tag != "gemma-2b":
            continue
        nbytes = _qkv_nbytes(h, nq, bb, n, kvn, d, x.element_size(),
                             nw.element_size(), d * pk.element_size(),
                             tables.numel() * 4 + bb * 4)
        qt, st = _int8pack(torch, wq[layer], ws[layer], dtype)
        timed: dict = {}
        _time_qkv(torch, "fused_qkv_append", tag + " d256",
                  lambda: qf.fused_qkv_append(
                      x, nw, wq, ws, sin, cos, *a, layer, pos, n_heads=n,
                      kv_heads=kvn, tables=tables),
                  lambda: qf.fused_qkv_append_ref(
                      x, nw, wq, ws, sin, cos, *r, layer, pos, n_heads=n,
                      kv_heads=kvn, tables=tables),
                  qr, nbytes, 2.0 * bb * h * nq, "bfloat16", (x, qt, st),
                  timed, extra, max(err, kv_err))
        results["fused_qkv_append_mma_d256"] = timed["fused_qkv_append_mma"]
        results["fused_qkv_append_d256"] = timed["fused_qkv_append"]

    # every paged form runs at D 256 (the INT8-KV forms since Gemma's
    # INT8-KV slice, check_int8kv_options; the e4m3 ones since its FP8-KV
    # slice, check_fp8kv_options); sinks at D 256 (no model with sinks has
    # it) still raise, named, before any launch, over e4m3 pools as over
    # pools of q's dtype
    pk, pv = _pools(torch, gen, dev, 2, 6, kvn, ps, d, bf)
    ek, ev = pk.to(torch.float8_e4m3fn), pv.to(torch.float8_e4m3fn)
    tables = _tables(torch, dev, 3, 2, dead_last=False)
    kv_lens = torch.tensor([5, 9, 2], dtype=torch.int32, device=dev)
    zero = torch.zeros(3, dtype=torch.int32, device=dev)
    q1 = torch.randn((3, n, d), generator=gen, device=dev, dtype=bf)
    q3 = torch.randn((3, 3, n, d), generator=gen, device=dev, dtype=bf)
    sinks = torch.zeros(n, device=dev)
    before = {k: w.launches for k, (w, _r) in _wrappers().items()}
    refused = {
        "4s": lambda: pd.paged_flash_decode(q1, pk, pv, tables, kv_lens, 0,
                                            sinks=sinks),
        "4es": lambda: pd.paged_flash_decode(q1, ek, ev, tables, kv_lens, 0,
                                             sinks=sinks),
        "4ves": lambda: pd.paged_flash_verify(q3, ek, ev, tables, kv_lens, 0,
                                              sinks=sinks),
        "8es": lambda: pp.paged_flash_prefill(q3, ek, ev, tables, kv_lens,
                                              zero, 0, sinks=sinks),
    }
    for form, call in refused.items():
        try:
            call()
        except NotImplementedError as e:
            require("head_dim 256" in str(e), f"{form} at D 256: {e}")
            continue
        raise SmokeFailure(f"{form} ran at D 256")
    require(before == {k: w.launches for k, (w, _r) in _wrappers().items()},
            "a sink form launched at D 256")
    print(f"[kernels] d256: sinks at D 256 raise NotImplementedError before "
          f"any launch: {', '.join(refused)}; the D-256 checks took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()


# google/gemma-2-2b config.json: hidden_size 2304, 8 heads over 4 kv heads
# of 256, attn_logit_softcapping 50.0, sliding_window 4096
GEMMA2 = dict(h=2304, n=8, kvn=4, d=256, cap=50.0)


def _scores_pass(torch, q, k, cap, scale):
    """The largest |score| of sequence 0, kv head 0's first q head (the
    cap bites where it is past ``cap``)."""
    s = (q[0, ..., 0, :].float() @ k[0, ..., 0, :].float().T) * scale
    return float(s.abs().max())


def check_gemma2(torch, dev, results, extra):
    """The capped forms at Gemma-2-2B's shapes (8 q heads over 4 kv heads,
    D 256, cap 50, window 4096, page 128) against their plain versions by
    the rules their uncapped forms use: 3c and 3wc at bench.py's prefill
    (8 x 128, the rows), past the cap (q x 60: |s| to several times the
    cap), a window of 100 across 700 rows whose walk splits, f32 and D
    128; 4c at `gemma2`'s decode context (the row) and kv_len 4096, and
    4wc over ring tables (R 35) at `gemma2_window`'s decode (4 rows at
    kv_len 4400-4543, the row), with window edges (kv_len 0, 1, 4096,
    4097) past the cap, D 128 and f32, the columns below the band on NaN
    pages; 8c at `gemma2_window`'s chunk (256 rows at offset 3840, the
    row) and 8wc at its chunk past the window over the ring (offset 4096,
    the row), ragged f32 and D-128 cases past the cap; 6k at `gemma2`'s
    decode (8 rows, H 2304, weights of layer 1 into pool layer 0; timed
    beside the FMA kernel forced). Each timed case beside its plain
    version, its bytes bound and scaled_dot_product_attention at the same
    shape without the cap (no PyTorch call computes the capped function
    without compiling)."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops import qkv_fused as qf
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.attention import flash_prefill as fp
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    from simplellminference_tpu_torch.ops.attention import paged_prefill as pp
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2304)
    bf, f32 = torch.bfloat16, torch.float32
    h, n, kvn, cap = GEMMA2["h"], GEMMA2["n"], GEMMA2["kvn"], GEMMA2["cap"]
    ps, layer = 128, 1
    uncapped = " (uncapped: the library computes no soft cap)"

    # 3c, 3wc: (b, s, window, q scale, dtype, d, kv heads); rows first
    cases = {"gemma-2-2b": (8, 128, None, 1.0, bf, 256, kvn),
             "gemma-2-2b window": (8, 128, WINDOW, 1.0, bf, 256, kvn),
             "past the cap": (2, 300, None, 60.0, bf, 256, kvn),
             "past the cap window 100": (1, 700, 100, 60.0, bf, 256, kvn),
             "d128 past the cap": (3, 200, 64, 60.0, bf, 128, 8),
             "f32 past the cap window 40": (2, 100, 40, 60.0, f32, 256,
                                            kvn)}
    for tag, (b, s, w, qx, dtype, d, kh) in cases.items():
        nh = 32 if d == 128 else n
        q = torch.randn((b, s, nh, d), generator=gen, device=dev,
                        dtype=dtype) * qx
        big = torch.randn((b, s, 2 * kh * d), generator=gen, device=dev,
                          dtype=dtype)
        k = big[..., :kh * d].reshape(b, s, kh, d)
        v = big[..., kh * d:].reshape(b, s, kh, d)
        got = fp.flash_prefill(q, k, v, window=w, logit_cap=cap)
        want = fp.flash_prefill_ref(q, k, v, window=w, logit_cap=cap)
        torch.cuda.synchronize()
        ok, err, note = _prefill_rule(torch, got, want)
        top = _scores_pass(torch, q, k, cap, d ** -0.5)
        print(f"[kernels] flash_prefill capped {tag} (B={b} S={s} N={nh} "
              f"kvN={kh} D={d} window={w} cap {cap}; max|score| {top:.1f}):"
              f" max|err| {err:.3e} ({note})", flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"flash_prefill capped {tag} disagrees: {err} ({note})")
        require(qx == 1.0 or top > cap, f"{tag}: the cap does not bite")
        if tag.startswith("f32"):
            continue
        qt = q.transpose(1, 2)
        kt = _gqa(torch, k.transpose(1, 2), nh).contiguous()
        vt = _gqa(torch, v.transpose(1, 2), nh).contiguous()
        keys = sum(min(i + 1, w or s) for i in range(s))
        es = q.element_size()
        bms, by = bound_ms((2 * b * s * nh * d + 2 * b * s * kh * d) * es,
                           4.0 * b * nh * d * keys, "bfloat16")
        if w is None:
            def lib(qt=qt, kt=kt, vt=vt):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
        else:
            mask = ref_ops.causal_mask(s, s, window=w, device=dev)

            def lib(qt=qt, kt=kt, vt=vt, mask=mask):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        row = ("flash_prefill_cap_d256" if w is None
               else "flash_prefill_window_cap_d256")
        res = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: fp.flash_prefill(
                q, k, v, window=w, logit_cap=cap)),
            plain_ms=time_ms(torch, lambda: fp.flash_prefill_ref(
                q, k, v, window=w, logit_cap=cap)),
            library_ms=time_ms(torch, lib), bound_ms=bms, bound_by=by,
            library=(LIBRARY[row] if d == 256 else LIBRARY[
                "flash_prefill" if w is None else "flash_prefill_window"]
                + uncapped))
        if tag.startswith("gemma-2-2b"):
            results[row] = res
        else:
            extra.append((row if d == 256 else "flash_prefill" + (
                "_window" if w else ""), tag, res))
        del big

    # 4c (table columns, dead last slot) and 4wc over the ring (R 35):
    # (lens, window, q scale, dtype, d); the rows first
    r_ring = (WINDOW + MISTRAL_CHUNK - 2) // ps + 2
    cases = {"gemma-2-2b": ([128 + 4 * i for i in range(8)], None, 1.0, bf,
                            256),
             "gemma-2-2b window": ([4400, 4480, 4500, 4543], WINDOW, 1.0,
                                   bf, 256),
             "gemma-2-2b kv_len 4096": ([4096] * 8, None, 1.0, bf, 256),
             "edges past the cap": ([0, 1, 4095, 4096, 4097, 4200, 300, 5],
                                    None, 60.0, bf, 256),
             "window edges past the cap": ([0, 1, 4096, 4097, 4100, 4479,
                                            4480, 4543], WINDOW, 60.0, bf,
                                           256),
             "d128 window past the cap": ([0, 150, 4097, 4543], WINDOW, 60.0,
                                          bf, 128),
             "f32 window past the cap": ([0, 7, 4097, 4300], WINDOW, 60.0,
                                         f32, 256)}
    for tag, (lens, w, qx, dtype, d) in cases.items():
        b = len(lens)
        nh, kh = (32, 8) if d == 128 else (n, kvn)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((b, nh, d), generator=gen, device=dev,
                        dtype=dtype) * qx
        mp = -(-max(max(lens), 1) // ps)
        if w is None:
            pk, pv = _pools(torch, gen, dev, 2, b * mp, kh, ps, d, dtype)
            clean = _tables(torch, dev, b, mp, dead_last=qx != 1.0)
            dirty = clean
        else:
            pk, pv = _ring_pools(torch, gen, dev, b, r_ring, kh, ps, d,
                                 dtype, False)
            clean = _ring_tables(torch, dev, b, r_ring, mp)
            dirty = _poisoned(torch, clean, kv - w, ps, b * r_ring)

        def run(tb, q=q, pk=pk, pv=pv, kv=kv, w=w):
            return pd.paged_flash_decode(q, pk, pv, tb, kv, layer, window=w,
                                         logit_cap=cap)

        got = run(dirty)
        want = pd.paged_flash_decode_ref(q, pk, pv, clean, kv, layer,
                                         window=w, logit_cap=cap)
        torch.cuda.synchronize()
        dead = ([i for i in range(b) if lens[i] == 0]
                + ([b - 1] if w is None and qx != 1.0 else []))
        err = _attn_check(torch, "paged_flash_decode capped", tag, got, want,
                          dead)
        same = bool(torch.equal(got, run(clean)))
        require(same, f"paged_flash_decode capped {tag}: a page below the "
                f"window band was read")
        if dtype == f32 or tag.startswith(("edges", "window edges")):
            continue
        es = q.element_size()
        span = [min(ln, w) if w else ln for ln in lens]
        kvb = 2 * sum(span) * kh * d * es
        bms, by = bound_ms(2 * b * nh * d * es + kvb + clean.numel() * 4
                           + b * 4, 4.0 * nh * d * sum(span), "bfloat16")
        ck, cv = gather_dense(pk[layer], pv[layer], clean)
        ck, cv = _gqa(torch, ck, nh), _gqa(torch, cv, nh)
        key_pos = torch.arange(ck.shape[2], device=dev)[None, None, None]
        mask = key_pos < kv.long()[:, None, None, None]
        if w:
            mask = mask & (key_pos >= kv.long()[:, None, None, None] - w)
        row = ("paged_flash_decode_cap_d256" if w is None
               else "paged_flash_decode_window_cap_d256")
        res = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: run(clean)),
            plain_ms=time_ms(torch, lambda: pd.paged_flash_decode_ref(
                q, pk, pv, clean, kv, layer, window=w, logit_cap=cap)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], ck, cv, attn_mask=mask)),
            bound_ms=bms, bound_by=by,
            library=(LIBRARY[row] if d == 256 else LIBRARY[
                "paged_flash_decode_window"] + uncapped))
        if tag in ("gemma-2-2b", "gemma-2-2b window"):
            results[row] = res
        else:
            extra.append((row if d == 256 else "paged_flash_decode_window",
                          tag, res))
        del ck, cv, pk, pv

    # 8c and 8wc (over the ring: R for the window's 256-row chunks, or for
    # a window of 300 and 128-row chunks): (Sq, offsets, kv_lens, window,
    # q scale, dtype, d, page); rows first
    cases = {"gemma-2-2b chunk": (256, [3840], [4096], None, 1.0, bf, 256,
                                  128),
             "gemma-2-2b window chunk": (256, [4096], [4352], WINDOW, 1.0,
                                         bf, 256, 128),
             "ragged past the cap": (100, [0, 48, 16, 0], [100, 130, 77, 1],
                                     None, 60.0, bf, 256, 16),
             "window 300 past the cap": (128, [512, 1024], [640, 1100], 300,
                                         60.0, bf, 256, 128),
             "d128 window 300 past the cap": (128, [512, 1024], [640, 1100],
                                              300, 60.0, bf, 128, 128),
             "f32 ragged past the cap": (100, [0, 48, 16, 0],
                                         [100, 130, 77, 1], None, 60.0, f32,
                                         256, 16)}
    for tag, (sq, offs, lens, w, qx, dtype, d, pss) in cases.items():
        b = len(offs)
        nh, kh = (32, 8) if d == 128 else (n, kvn)
        mp = -(-max(o + sq for o in offs) // pss)
        off_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        kv_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        if w is None:
            pk, pv = _pools(torch, gen, dev, 2, b * mp, kh, pss, d, dtype)
            clean = _tables(torch, dev, b, mp, dead_last=qx != 1.0)
            if qx != 1.0:
                clean[2, 1] = -1          # inside row 2's kv_len
            dirty = clean
        else:
            rr = (w + sq - 2) // pss + 2 if w != WINDOW else r_ring
            pk, pv = _ring_pools(torch, gen, dev, b, rr, kh, pss, d, dtype,
                                 False)
            clean = _ring_tables(torch, dev, b, rr, mp)
            dirty = _poisoned(torch, clean, off_t - w + 1, pss, b * rr)
        q = torch.randn((b, sq, nh, d), generator=gen, device=dev,
                        dtype=dtype) * qx

        def run(tb, q=q, pk=pk, pv=pv, kv_t=kv_t, off_t=off_t, w=w):
            return pp.paged_flash_prefill(q, pk, pv, tb, kv_t, off_t, layer,
                                          window=w, logit_cap=cap)

        got = run(dirty)
        want = pp.paged_flash_prefill_ref(q, pk, pv, clean, kv_t, off_t,
                                          layer, window=w, logit_cap=cap)
        torch.cuda.synchronize()
        ok, err, note = _prefill_rule(torch, got, want)
        same = bool(torch.equal(got, run(clean)))
        print(f"[kernels] paged_flash_prefill capped {tag} (B={b} Sq={sq} "
              f"D={d} ps={pss} window={w}): max|err| {err:.3e} ({note}); "
              f"NaN pages below the band unread: {same}", flush=True)
        require(bool(torch.isfinite(got).all()) and ok and same,
                f"paged_flash_prefill capped {tag} disagrees: {err} ({note})"
                f", unchanged {same}")
        if dtype == f32 or "ragged" in tag:
            continue
        es = q.element_size()
        keys = sum(min(o + i + 1, ln) - (max(0, o + i - w + 1) if w else 0)
                   for o, ln in zip(offs, lens) for i in range(sq)
                   if o + i < ln)
        rows = sum(min(ln, o + sq) - (max(0, o - w + 1) if w else 0)
                   for o, ln in zip(offs, lens))
        bms, by = bound_ms(2 * b * sq * nh * d * es + 2 * rows * kh * d * es
                           + clean.numel() * 4 + 2 * b * 4,
                           4.0 * nh * d * keys, "bfloat16")
        ck, cv = gather_dense(pk[layer], pv[layer], clean)
        ck, cv = _gqa(torch, ck, nh), _gqa(torch, cv, nh)
        key_pos = torch.arange(ck.shape[2], device=dev)
        q_pos = off_t.long()[:, None] + torch.arange(sq, device=dev)[None]
        mask = ((key_pos[None, None] <= q_pos[:, :, None])
                & (key_pos[None, None] < kv_t.long()[:, None, None]))
        if w:
            mask = mask & (key_pos[None, None] > q_pos[:, :, None] - w)
        mask = mask[:, None]
        qt = q.transpose(1, 2)
        row = ("paged_flash_prefill_cap_d256" if w is None
               else "paged_flash_prefill_window_cap_d256")
        res = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: run(clean)),
            plain_ms=time_ms(torch, lambda: pp.paged_flash_prefill_ref(
                q, pk, pv, clean, kv_t, off_t, layer, window=w,
                logit_cap=cap)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, ck, cv, attn_mask=mask)),
            bound_ms=bms, bound_by=by,
            library=(LIBRARY[row] if d == 256 else LIBRARY[
                "paged_flash_prefill_window"] + uncapped))
        if tag.startswith("gemma-2-2b"):
            results[row] = res
        else:
            extra.append((row if d == 256 else "paged_flash_prefill_window",
                          tag, res))
        del ck, cv, pk, pv

    # 6k at D 256: `gemma2`'s decode (8 rows) and one row, weights of
    # layer 1, pools at layer 0 (the ring pools' index)
    d = GEMMA2["d"]
    nq = (n + 2 * kvn) * d
    for tag, bb in {"gemma-2-2b": 8, "gemma-2-2b m1": 1}.items():
        wq, ws = _qweight(torch, gen, dev, (2, h, nq), 1)
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(bf)
        x = torch.randn((bb, h), generator=gen, device=dev).to(bf)
        pos = (128 + 4 * torch.arange(bb, device=dev)).to(torch.int32)
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        mp = 3
        pk, pv = _pools(torch, gen, dev, 2, bb * mp, kvn, ps, d, bf)
        tables = _ring_tables(torch, dev, bb, mp, mp)
        a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
        qa, *_ = qf.fused_qkv_append_kv_layer(x, nw, wq, ws, sin, cos, *a,
                                              layer, 0, pos, tables,
                                              n_heads=n, kv_heads=kvn)
        qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, layer,
                                         pos, n_heads=n, kv_heads=kvn,
                                         tables=tables, kv_layer=0)
        torch.cuda.synchronize()
        page = tables.long()[torch.arange(bb, device=dev), pos.long() // ps]
        written = torch.zeros(pk.shape, dtype=torch.bool, device=dev)
        written[0, page, :, pos.long() % ps] = True
        err = max_err(qa, qr)
        kv_err = max(max_err(ta[written], tr[written]) for ta, tr in zip(a, r))
        untouched = all(torch.equal(ta[~written], tr[~written])
                        for ta, tr in zip(a, r))
        lim_q = TOL["bfloat16"] * float(qr.float().std())
        lim_kv = TOL["bfloat16"] * max(float(tr[written].float().std())
                                       for tr in r)
        print(f"[kernels] fused_qkv_append_kv_layer d256 {tag} "
              f"({qf.qkv_regime(bb, h, nq, d, bf)}; layer {layer}, pool "
              f"layer 0): q max|err| {err:.3e} (tol {lim_q:.3e}); k/v rows "
              f"{kv_err:.3e} (tol {lim_kv:.3e}); other pool entries equal: "
              f"{untouched}", flush=True)
        require(bool(torch.isfinite(qa).all()) and err <= lim_q
                and kv_err <= lim_kv and untouched,
                f"fused_qkv_append_kv_layer d256 {tag} disagrees: {err}, "
                f"{kv_err}, {untouched}")
        if tag != "gemma-2-2b":
            continue
        nbytes = _qkv_nbytes(h, nq, bb, n, kvn, d, x.element_size(),
                             nw.element_size(), d * pk.element_size(),
                             tables.numel() * 4 + bb * 4)
        qt, st = _int8pack(torch, wq[layer], ws[layer], bf)
        timed: dict = {}
        _time_qkv(torch, "fused_qkv_append_kv_layer", tag + " d256",
                  lambda: qf.fused_qkv_append_kv_layer(
                      x, nw, wq, ws, sin, cos, *a, layer, 0, pos, tables,
                      n_heads=n, kv_heads=kvn),
                  lambda: qf.fused_qkv_append_ref(
                      x, nw, wq, ws, sin, cos, *r, layer, pos, n_heads=n,
                      kv_heads=kvn, tables=tables, kv_layer=0),
                  qr, nbytes, 2.0 * bb * h * nq, "bfloat16", (x, qt, st),
                  timed, extra, max(err, kv_err))
        results["fused_qkv_append_kv_layer_d256"] = timed[
            "fused_qkv_append_mma"]
    print(f"[kernels] gemma-2-2b: the capped and D-256 window checks took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()


# Gemma-2 on the dense arena and under speculation: 13w, 13c, 13wc and the
# verify forms at D 256 and capped. Gemma-2-9B (google/gemma-2-9b): 16 q
# heads over 8 kv heads of 256, the same caps and window.
GEMMA2_9B = dict(n=16, kvn=8, d=256)
DENSE_SMAX = 8192      # between `gemma2_dense`'s arena (4608 slots) and
                       # the Gemma-2-2B draft's (8320)


def _verify_keys(lens, s, w):
    """(keys the verify rows attend, K/V rows they need) over the
    sequences' rows s' at positions kv_len - S + s': keys <= the position
    and, with a window ``w``, > the position - w."""
    keys = rows = 0
    for ln in lens:
        lo = max(0, ln - s - w + 1) if w else 0
        rows += max(0, ln - lo)
        for r in range(s):
            p = ln - s + r
            keys += max(0, p + 1 - (max(0, p - w + 1) if w else 0))
    return keys, rows


def check_gemma2_dense(torch, dev, results, extra):
    """The dense arena's window and capped forms (13w, 13c, 13wc) and the
    verify forms at D 256 and capped (4v/256, 4vw/256, 4vc, 4vwc) against
    their plain versions by the rounding rule. 13c/256 and 13wc/256 at
    `gemma2_dense`'s decode (4 rows, 8 q heads over 4 kv heads of 256, an
    arena of 8192 slots, kv_len 4224-4288: the sliding layers' window
    trims; the rows) and the draft's rollout (9 rows at kv_len ~150);
    kv_len 0, 1, below the window, its edges, past it and the whole arena,
    past the cap (q x 60), f32 and D 128; 13w at Mistral-7B's decode (32
    over 8 heads of 128, window 4096; the row). The verify forms at S 5:
    4v/256 and 4vw/256 at Gemma-1's group of 8 (40 rows: two row blocks;
    the rows, and kv_len 4096), 4vc/256 at `gemma2_spec`'s verify step (8
    rows at context ~150) and 4vwc/256 over the ring tables (R 35) at
    kv_len 4224-4504, both at Gemma-2-2B's and Gemma-2-9B's groups of 2
    (the rows: 2B's), window edges past the cap, f32, D 128; the ring
    columns below the band on NaN pages, which no form may read. Each
    timed case beside its plain version, its bytes bound and
    scaled_dot_product_attention with the same mask (uncapped where the
    form caps)."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(3584)
    bf, f32 = torch.bfloat16, torch.float32
    cap, layer, ps = GEMMA2["cap"], 1, 128
    g2 = (GEMMA2["n"], GEMMA2["kvn"], GEMMA2["d"])
    g1 = (GEMMA["n"], GEMMA["kvn"], GEMMA["d"])
    g9 = (GEMMA2_9B["n"], GEMMA2_9B["kvn"], GEMMA2_9B["d"])
    mistral = (32, 8, 128)
    uncapped = " (uncapped: the library computes no soft cap)"
    dense_lens = [4224, 4245, 4266, 4288]
    edges = [0, 1, 100, 4095, 4096, 4097, 4543, DENSE_SMAX]

    # 13c, 13wc, 13w: tag -> (heads, window, cap, q scale, dtype, lens,
    # kernels-line row if timed)
    cases = {
        "gemma-2-2b": (g2, None, cap, 1.0, bf, dense_lens,
                       "flash_decode_cap_d256"),
        "gemma-2-2b window": (g2, WINDOW, cap, 1.0, bf, dense_lens,
                              "flash_decode_window_cap_d256"),
        "gemma-2-2b draft rollout": (g2, WINDOW, cap, 1.0, bf,
                                     [150 + 2 * i for i in range(8)] + [1],
                                     "flash_decode_window_cap_d256"),
        "mistral-7b window": (mistral, WINDOW, None, 1.0, bf,
                              [4224 + 40 * i for i in range(8)],
                              "flash_decode_window"),
        "edges past the cap": (g2, None, cap, 60.0, bf, edges, None),
        "window edges past the cap": (g2, WINDOW, cap, 60.0, bf, edges,
                                      None),
        "f32 window past the cap": (g2, WINDOW, cap, 60.0, f32,
                                    [0, 7, 4097, 5000], None),
        "d128 window past the cap": (mistral, WINDOW, cap, 60.0, bf,
                                     [0, 150, 4097, 4543], None),
    }
    for tag, ((n, kvn, d), w, cp, qx, dtype, lens, row) in cases.items():
        b = len(lens)
        ck, cv = _arena(torch, gen, dev, 2, b + 1, kvn, DENSE_SMAX, d, dtype)
        q = torch.randn((b, n, d), generator=gen, device=dev,
                        dtype=dtype) * qx
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)

        def run(q=q, ck=ck, cv=cv, kv=kv, w=w, cp=cp):
            return fd.flash_decode(q, ck, cv, kv, layer=layer, window=w,
                                   logit_cap=cp)

        def plain(q=q, ck=ck, cv=cv, kv=kv, w=w, cp=cp):
            return fd.flash_decode_ref(q, ck, cv, kv, layer=layer,
                                       window=w, logit_cap=cp)

        got, want = run(), plain()
        torch.cuda.synchronize()
        err = _attn_check(torch, "flash_decode", f"{tag} (B={b} N={n} "
                          f"kvN={kvn} D={d} Smax={DENSE_SMAX} window={w} "
                          f"cap {cp})", got, want,
                          [i for i in range(b) if lens[i] == 0])
        if row is None:
            del ck, cv
            continue
        span = [min(ln, DENSE_SMAX) - (max(0, ln - w) if w else 0)
                for ln in lens]
        es = q.element_size()
        bms, by = bound_ms(2 * b * n * d * es + 2 * sum(span) * kvn * d * es
                           + b * 4, 4.0 * n * d * sum(span), "bfloat16")
        top = max(lens)
        k4 = _gqa(torch, ck[layer, :b, :, :top], n)
        v4 = _gqa(torch, cv[layer, :b, :, :top], n)
        key_pos = torch.arange(top, device=dev)[None, None, None, :]
        mask = key_pos < kv.long()[:, None, None, None]
        if w:
            mask = mask & (key_pos >= kv.long()[:, None, None, None] - w)
        res = dict(
            max_abs_err=err, ms=time_ms(torch, run),
            plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], k4, v4, attn_mask=mask)),
            bound_ms=bms, bound_by=by, library=LIBRARY[row])
        if tag in ("gemma-2-2b", "gemma-2-2b window", "mistral-7b window"):
            results[row] = res
        else:
            extra.append((row, tag, res))
        del ck, cv, k4, v4

    # the verify forms, S 5: tag -> (heads, window, cap, q scale, dtype,
    # lens, kernels-line row if timed); a window over the ring tables
    s_rows = 5
    r_ring = (WINDOW + MISTRAL_CHUNK - 2) // ps + 2
    spec_lens = [147 + 2 * i for i in range(8)]
    long_lens = [4224 + 40 * i for i in range(8)]
    cases = {
        "gemma-1": (g1, None, None, 1.0, bf, spec_lens,
                    "paged_flash_verify_d256"),
        "gemma-1 window": (g1, WINDOW, None, 1.0, bf, long_lens,
                           "paged_flash_verify_window_d256"),
        "gemma-1 kv_len 4096": (g1, None, None, 1.0, bf, [4096] * 8,
                                "paged_flash_verify_d256"),
        "gemma-2-2b": (g2, None, cap, 1.0, bf, spec_lens,
                       "paged_flash_verify_cap_d256"),
        "gemma-2-2b window": (g2, WINDOW, cap, 1.0, bf, long_lens,
                              "paged_flash_verify_window_cap_d256"),
        "gemma-2-9b": (g9, None, cap, 1.0, bf, spec_lens,
                       "paged_flash_verify_cap_d256"),
        "gemma-2-9b window": (g9, WINDOW, cap, 1.0, bf, long_lens,
                              "paged_flash_verify_window_cap_d256"),
        "d128 past the cap": (mistral, None, cap, 60.0, bf, spec_lens,
                              "paged_flash_verify"),
        "d128 window past the cap": (mistral, WINDOW, cap, 60.0, bf,
                                     [0, 150, 4097, 4543],
                                     "paged_flash_verify_window"),
        "gemma-1 f32": (g1, None, None, 1.0, f32, [0, 7, 129, 300], None),
        "edges past the cap": (g2, None, cap, 60.0, bf,
                               [0, 1, 3, 5, 4096, 4097, 4200, 300], None),
        "window edges past the cap": (g2, WINDOW, cap, 60.0, bf,
                                      [0, 1, 4096, 4097, 4100, 4479, 4480,
                                       4543], None),
        "f32 window past the cap": (g2, WINDOW, cap, 60.0, f32,
                                    [0, 7, 4097, 4300], None),
    }
    for tag, ((n, kvn, d), w, cp, qx, dtype, lens, row) in cases.items():
        b = len(lens)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        mp = -(-max(max(lens), 1) // ps)
        if w is None:
            pk, pv = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, dtype)
            clean = _tables(torch, dev, b, mp, dead_last=False)
            dirty = clean
        else:
            pk, pv = _ring_pools(torch, gen, dev, b, r_ring, kvn, ps, d,
                                 dtype, False)
            clean = _ring_tables(torch, dev, b, r_ring, mp)
            dirty = _poisoned(torch, clean, kv - s_rows - w + 1, ps,
                              b * r_ring)
        q = torch.randn((b, s_rows, n, d), generator=gen, device=dev,
                        dtype=dtype) * qx

        def run(tb, q=q, pk=pk, pv=pv, kv=kv, w=w, cp=cp):
            return pd.paged_flash_verify(q, pk, pv, tb, kv, layer, window=w,
                                         logit_cap=cp)

        def plain(q=q, pk=pk, pv=pv, clean=clean, kv=kv, w=w, cp=cp):
            return pd.paged_flash_verify_ref(q, pk, pv, clean, kv, layer,
                                             window=w, logit_cap=cp)

        got, want = run(dirty), plain()
        torch.cuda.synchronize()
        err = _attn_check(torch, "paged_flash_verify", f"{tag} (B={b} S="
                          f"{s_rows} N={n} kvN={kvn} D={d} window={w} cap "
                          f"{cp})", got, want,
                          [i for i in range(b) if lens[i] == 0])
        same = bool(torch.equal(got, run(clean)))
        require(same, f"paged_flash_verify {tag}: a page below the window "
                f"band was read")
        if row is None:
            del pk, pv
            continue
        keys, kv_rows = _verify_keys(lens, s_rows, w)
        es = q.element_size()
        bms, by = bound_ms(2 * b * s_rows * n * d * es
                           + 2 * kv_rows * kvn * d * es + clean.numel() * 4
                           + b * 4, 4.0 * n * d * keys, "bfloat16")
        ck, cv = gather_dense(pk[layer], pv[layer], clean)
        ck, cv = _gqa(torch, ck, n), _gqa(torch, cv, n)
        key_pos = torch.arange(ck.shape[2], device=dev)
        q_pos = (kv.long()[:, None] - s_rows
                 + torch.arange(s_rows, device=dev)[None])
        mask = key_pos[None, None] <= q_pos[:, :, None]
        if w:
            mask = mask & (key_pos[None, None] > q_pos[:, :, None] - w)
        mask = mask[:, None]
        qt = q.transpose(1, 2)
        res = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: run(clean)),
            plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, ck, cv, attn_mask=mask)),
            bound_ms=bms, bound_by=by,
            library=LIBRARY[row] + (uncapped if cp and d != 256 else ""))
        if tag in ("gemma-1", "gemma-1 window", "gemma-2-2b",
                   "gemma-2-2b window"):
            results[row] = res
        else:
            extra.append((row, tag, res))
        del ck, cv, pk, pv
    print(f"[kernels] gemma-2 dense and verify: the checks took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()


# gpt-oss-20b (openai/gpt-oss-20b): 64 q heads over 8 kv heads of 64,
# window 128 on the sliding layers, attention sinks drawn N(0, 1) as the
# JAX package's init_params draws them
GPT_OSS = dict(n=64, kvn=8, d=64, window=128)
BIG_SINK = 10.0   # above every score of unit q and k at D**-0.5 (checked)


def _sink_draw(torch, gen, dev, n, big):
    """A layer's sinks as the model holds them (bf16 values in f32):
    N(0, 1), or BIG_SINK, above every score of their rows, so that a sink
    counted twice or in the wrong units moves each output by far more
    than the rule allows."""
    if big:
        return torch.full((n,), BIG_SINK, device=dev)
    return torch.randn((n,), generator=gen, device=dev).to(
        torch.bfloat16).float()


def _top_score(torch, q, k, scale):
    """The largest |score| of sequence 0's first q head over its kv
    head's keys (q [.., N, D] rows, k [.., kvN, D] rows)."""
    qs = q[0].reshape(-1, q.shape[-2], q.shape[-1])[:, 0].float()
    ks = k[0].reshape(-1, k.shape[-2], k.shape[-1])[:, 0].float()
    return float((qs @ ks.T).abs().max()) * scale


def _sink_rule(torch, name, tag, got, want, big, top, dead=()):
    """A sink form against its plain version by :func:`_rounding_rule`,
    rows ``dead`` zero, and with a sink above every score (``big``) the
    largest |score| ``top`` below it. Returns max|err|."""
    ok, err, share, note = _rounding_rule(torch, got, want)
    zero = all(bool((got[i] == 0).all()) for i in dead)
    print(f"[kernels] {name} {tag}: max|err| {err:.3e} ({note}; the worst "
          f"element at {share:.3f} of its limit); max|score| {top:.2f}"
          f"{f' < sink {BIG_SINK}' if big else ''}; rows without keys "
          f"zero: {zero}", flush=True)
    require(bool(torch.isfinite(got).all()) and ok and zero,
            f"{name} {tag} disagrees: {err} ({share:.3f} of the limit), "
            f"zero rows {zero}")
    require(not big or top < BIG_SINK, f"{name} {tag}: a score {top} "
            f"passes the sink {BIG_SINK}")
    return err


def check_gpt_oss(torch, dev, results, extra):
    """The sink forms at gpt-oss-20b's attention (64 q heads over 8 kv
    heads, D 64, window 128, page 128) against their plain versions by
    :func:`_rounding_rule` (one bf16 ulp of each output + 1e-5 of the
    largest; f32 within 1e-5 of the largest): 3s and 3ws at bench.py's
    prefill (8 x 128 rows, the rows) and a window of 40 across 300 rows
    with a sink above every score; 4s at `gpt_oss`'s decode (8 rows at
    kv_len 128-156, the row), at kv_len 4096 where ``decode_splits`` splits
    the key walk (sinks above every score: a sink seeded in every split
    would be counted four times), edges (kv_len 0, 1, a dead slot), f32;
    4ws over ring tables (the grouped engine's R 3) at window edges, the
    columns below the band on NaN pages; 8s at `gpt_oss_prefix`'s chunk
    (256 rows at offset 256 over 512 keys, the row) and 8ws at its last
    chunk over the ring (offset 512, the row), 64 rows at offset 4096 (the
    key walk split over 4 blocks) and a ragged batch with a sink above
    every score, f32. Each row's case timed beside its plain
    version, its bytes bound and scaled_dot_product_attention at the same
    shape without sinks (no PyTorch call computes the sink's softmax
    without compiling)."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.attention import flash_prefill as fp
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    from simplellminference_tpu_torch.ops.attention import paged_prefill as pp
    from simplellminference_tpu_torch.ops.attention import prefill_tiles
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2880)
    bf, f32 = torch.bfloat16, torch.float32
    n, kvn, d, win = (GPT_OSS["n"], GPT_OSS["kvn"], GPT_OSS["d"],
                      GPT_OSS["window"])
    ps, layer, scale = 128, 1, GPT_OSS["d"] ** -0.5

    # 3s, 3ws: (b, s, window, big sink, dtype); the rows first
    cases = {"gpt-oss-20b": (8, 128, None, False, bf),
             "gpt-oss-20b window": (8, 128, win, False, bf),
             "window 40 sink above": (2, 300, 40, True, bf),
             "f32 window 40": (2, 200, 40, False, f32)}
    for tag, (b, sl, w, big, dtype) in cases.items():
        q = torch.randn((b, sl, n, d), generator=gen, device=dev,
                        dtype=dtype)
        qkv = torch.randn((b, sl, 2 * kvn * d), generator=gen, device=dev,
                          dtype=dtype)
        k = qkv[..., :kvn * d].reshape(b, sl, kvn, d)
        v = qkv[..., kvn * d:].reshape(b, sl, kvn, d)
        sinks = _sink_draw(torch, gen, dev, n, big)
        got = fp.flash_prefill(q, k, v, window=w, sinks=sinks)
        want = fp.flash_prefill_ref(q, k, v, window=w, sinks=sinks)
        torch.cuda.synchronize()
        splits = prefill_tiles.launch_splits(b, sl, n, kvn, w or 0, sl)
        err = _sink_rule(
            torch, "flash_prefill sinks", f"{tag} (B={b} S={sl} N={n} "
            f"kvN={kvn} D={d} window={w}, {splits} splits)", got, want, big,
            _top_score(torch, q, k, scale))
        if not tag.startswith("gpt-oss-20b"):
            continue
        qt = q.transpose(1, 2)
        kt = _gqa(torch, k.transpose(1, 2), n).contiguous()
        vt = _gqa(torch, v.transpose(1, 2), n).contiguous()
        keys = sum(min(i + 1, w or sl) for i in range(sl))
        es = q.element_size()
        bms, by = bound_ms((2 * b * sl * n * d + 2 * b * sl * kvn * d) * es
                           + 4 * n, 4.0 * b * n * d * keys, "bfloat16")
        mask = ref_ops.causal_mask(sl, sl, window=w, device=dev)
        row = ("flash_prefill_sinks" if w is None
               else "flash_prefill_window_sinks")
        results[row] = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: fp.flash_prefill(q, k, v, window=w,
                                                       sinks=sinks)),
            plain_ms=time_ms(torch, lambda: fp.flash_prefill_ref(
                q, k, v, window=w, sinks=sinks)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)), bound_ms=bms, bound_by=by,
            library=LIBRARY[row])
        del qkv

    # 4s (table columns, a dead last slot) and 4ws over the ring: (lens,
    # window, big sink, dtype); the rows first
    r_ring = (win + 128 - 2) // ps + 2    # the engine's ring, chunk 0
    cases = {"gpt-oss-20b": ([128 + 4 * i for i in range(8)], None, False,
                             bf),
             "gpt-oss-20b window": ([128 + 4 * i for i in range(8)], win,
                                    False, bf),
             "kv_len 4096 sink above": ([4096] * 8, None, True, bf),
             "edges": ([0, 1, 63, 64, 65, 4095, 300, 5], None, False, bf),
             "window edges sink above": ([0, 1, 127, 128, 129, 255, 256,
                                          1000], win, True, bf),
             "f32 window": ([0, 7, 129, 700], win, False, f32),
             "f32 kv_len 4096": ([4096, 4000, 17, 0], None, False, f32)}
    for tag, (lens, w, big, dtype) in cases.items():
        b = len(lens)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((b, n, d), generator=gen, device=dev, dtype=dtype)
        mp = -(-max(max(lens), 1) // ps)
        if w is None:
            pk, pv = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, dtype)
            clean = _tables(torch, dev, b, mp, dead_last=tag == "edges")
            dirty = clean
        else:
            pk, pv = _ring_pools(torch, gen, dev, b, r_ring, kvn, ps, d,
                                 dtype, False)
            clean = _ring_tables(torch, dev, b, r_ring, mp)
            dirty = _poisoned(torch, clean, kv - w, ps, b * r_ring)
        sinks = _sink_draw(torch, gen, dev, n, big)

        def run(tb, q=q, pk=pk, pv=pv, kv=kv, w=w, sinks=sinks):
            return pd.paged_flash_decode(q, pk, pv, tb, kv, layer, window=w,
                                         sinks=sinks)

        got = run(dirty)
        want = pd.paged_flash_decode_ref(q, pk, pv, clean, kv, layer,
                                         window=w, sinks=sinks)
        torch.cuda.synchronize()
        span = mp * ps if not w else min(mp * ps, w)
        splits = pd.decode_splits(b, kvn, span)
        dead = ([i for i in range(b) if lens[i] == 0]
                + ([b - 1] if tag == "edges" else []))
        ck, cv = gather_dense(pk[layer], pv[layer], clean)
        err = _sink_rule(
            torch, "paged_flash_decode sinks", f"{tag} (B={b} kv_lens "
            f"{lens[:4]}.. window={w}, {splits} splits)", got, want, big,
            _top_score(torch, q[:, None], ck.transpose(1, 2), scale), dead)
        require(not big or w or splits > 1,
                f"paged_flash_decode sinks {tag}: one split only")
        same = bool(torch.equal(got, run(clean)))
        require(same, f"paged_flash_decode sinks {tag}: a page below the "
                f"window band was read")
        if not tag.startswith("gpt-oss-20b"):
            del ck, cv, pk, pv
            continue
        es = q.element_size()
        span_keys = [min(ln, w) if w else ln for ln in lens]
        kvb = 2 * sum(span_keys) * kvn * d * es
        bms, by = bound_ms(2 * b * n * d * es + kvb + clean.numel() * 4
                           + b * 4 + 4 * n, 4.0 * n * d * sum(span_keys),
                           "bfloat16")
        ck, cv = _gqa(torch, ck, n), _gqa(torch, cv, n)
        key_pos = torch.arange(ck.shape[2], device=dev)[None, None, None]
        mask = key_pos < kv.long()[:, None, None, None]
        if w:
            mask = mask & (key_pos >= kv.long()[:, None, None, None] - w)
        row = ("paged_flash_decode_sinks" if w is None
               else "paged_flash_decode_window_sinks")
        results[row] = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: run(clean)),
            plain_ms=time_ms(torch, lambda: pd.paged_flash_decode_ref(
                q, pk, pv, clean, kv, layer, window=w, sinks=sinks)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], ck, cv, attn_mask=mask)),
            bound_ms=bms, bound_by=by, library=LIBRARY[row])
        del ck, cv, pk, pv

    # 8s and 8ws (over the ring for 256-row chunks): (Sq, offsets, kv_lens,
    # window, big sink, dtype, page); rows first
    r_chunk = (win + 256 - 2) // ps + 2
    cases = {"gpt-oss-20b chunk": (256, [256], [512], None, False, bf, 128),
             "gpt-oss-20b window chunk": (256, [512], [576], win, False, bf,
                                          128),
             "split sink above": (64, [4096], [4160], None, True, bf, 128),
             "ragged sink above": (100, [0, 48, 16, 0], [100, 130, 77, 1],
                                   None, True, bf, 16),
             "window ragged sink above": (128, [512, 1024, 0],
                                          [640, 1100, 60], win, True, bf,
                                          128),
             "f32 window ragged": (100, [0, 256, 16, 0], [100, 300, 77, 1],
                                   win, False, f32, 128)}
    for tag, (sq, offs, lens, w, big, dtype, pss) in cases.items():
        b = len(offs)
        mp = -(-max(o + sq for o in offs) // pss)
        off_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        kv_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        if w is None:
            pk, pv = _pools(torch, gen, dev, 2, b * mp, kvn, pss, d, dtype)
            ragged = b > 2
            clean = _tables(torch, dev, b, mp, dead_last=ragged)
            if ragged:
                clean[2, 1] = -1          # inside row 2's kv_len
            dirty = clean
        else:
            rr = (w + sq - 2) // pss + 2 if sq != 256 else r_chunk
            pk, pv = _ring_pools(torch, gen, dev, b, rr, kvn, pss, d, dtype,
                                 False)
            clean = _ring_tables(torch, dev, b, rr, mp)
            dirty = _poisoned(torch, clean, off_t - w + 1, pss, b * rr)
        q = torch.randn((b, sq, n, d), generator=gen, device=dev,
                        dtype=dtype)
        sinks = _sink_draw(torch, gen, dev, n, big)

        def run(tb, q=q, pk=pk, pv=pv, kv_t=kv_t, off_t=off_t, w=w,
                sinks=sinks):
            return pp.paged_flash_prefill(q, pk, pv, tb, kv_t, off_t, layer,
                                          window=w, sinks=sinks)

        got = run(dirty)
        want = pp.paged_flash_prefill_ref(q, pk, pv, clean, kv_t, off_t,
                                          layer, window=w, sinks=sinks)
        torch.cuda.synchronize()
        splits = prefill_tiles.launch_splits(b, sq, n, kvn, w or 0,
                                             mp * pss)
        ck, cv = gather_dense(pk[layer], pv[layer], clean)
        err = _sink_rule(
            torch, "paged_flash_prefill sinks", f"{tag} (B={b} Sq={sq} D={d}"
            f" ps={pss} window={w}, {splits} splits)", got, want, big,
            _top_score(torch, q, ck.transpose(1, 2), scale))
        require(not tag.startswith("split") or splits > 1,
                f"paged_flash_prefill sinks {tag}: one split only")
        same = bool(torch.equal(got, run(clean)))
        require(same, f"paged_flash_prefill sinks {tag}: a page below the "
                f"window band was read")
        if not tag.startswith("gpt-oss-20b"):
            del ck, cv, pk, pv
            continue
        es = q.element_size()
        keys = sum(min(o + i + 1, ln) - (max(0, o + i - w + 1) if w else 0)
                   for o, ln in zip(offs, lens) for i in range(sq)
                   if o + i < ln)
        rows = sum(min(ln, o + sq) - (max(0, o - w + 1) if w else 0)
                   for o, ln in zip(offs, lens))
        bms, by = bound_ms(2 * b * sq * n * d * es + 2 * rows * kvn * d * es
                           + clean.numel() * 4 + 2 * b * 4 + 4 * n,
                           4.0 * n * d * keys, "bfloat16")
        ck, cv = _gqa(torch, ck, n), _gqa(torch, cv, n)
        key_pos = torch.arange(ck.shape[2], device=dev)
        q_pos = off_t.long()[:, None] + torch.arange(sq, device=dev)[None]
        mask = ((key_pos[None, None] <= q_pos[:, :, None])
                & (key_pos[None, None] < kv_t.long()[:, None, None]))
        if w:
            mask = mask & (key_pos[None, None] > q_pos[:, :, None] - w)
        mask = mask[:, None]
        qt = q.transpose(1, 2)
        row = ("paged_flash_prefill_sinks" if w is None
               else "paged_flash_prefill_window_sinks")
        results[row] = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: run(clean)),
            plain_ms=time_ms(torch, lambda: pp.paged_flash_prefill_ref(
                q, pk, pv, clean, kv_t, off_t, layer, window=w,
                sinks=sinks)),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, ck, cv, attn_mask=mask)),
            bound_ms=bms, bound_by=by, library=LIBRARY[row])
        del ck, cv, pk, pv
    print(f"[kernels] gpt-oss-20b: the sink checks took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()


# `gpt_oss_dense`'s arena: 8 rows of 256 slots (bench.py's 128-token
# prompts + 64 steps, rounded up to 256 by Generator.new_cache)
OSS_DENSE_SMAX = 256


def check_gpt_oss_spec_dense(torch, dev, results, extra):
    """The sink forms on verify rows and on the dense arena at gpt-oss-20b's
    attention (64 q heads over 8 kv heads, D 64, window 128) against their
    plain versions by :func:`_rounding_rule`. 4vs and 4vws at S 5 (40 rows a
    kv head: two row blocks of 32 and 8): `gpt_oss_spec`'s verify step (8
    sequences at context ~150, the rows; the window over ring tables of R
    3, the columns below the band on NaN pages, which no form may read),
    kv_len 4096 with a sink above every score (``decode_splits`` splits
    the key walk: a sink seeded in every split, or in only one row block,
    would miss by far more than the rule), edges (kv_len 0, 1, 4 and 5:
    rows before position 0, a dead slot), f32. 13s and 13ws at
    `gpt_oss_dense`'s decode (8 rows at kv_len 160-216 over its arena of
    256 slots: the window trims; the rows), an arena of 4224 slots at
    kv_len 4096 with a sink above every score (the walk split), edges
    (kv_len 0, 1, the window's edges, the whole arena), f32. Each row's
    case timed beside its plain version, its bytes bound and
    scaled_dot_product_attention at the same shape without sinks."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2881)
    bf, f32 = torch.bfloat16, torch.float32
    n, kvn, d, win = (GPT_OSS["n"], GPT_OSS["kvn"], GPT_OSS["d"],
                      GPT_OSS["window"])
    ps, layer, scale, s_rows = 128, 1, GPT_OSS["d"] ** -0.5, 5

    # 4vs, 4vws over the ring: (lens, window, big sink, dtype); rows first
    r_ring = (win + 128 - 2) // ps + 2
    spec_lens = [147 + 2 * i for i in range(8)]
    require(pd.row_blocks((n // kvn) * s_rows) == 2,
            "gpt-oss-20b's verify rows take one row block")
    cases = {"gpt-oss-20b": (spec_lens, None, False, bf),
             "gpt-oss-20b window": (spec_lens, win, False, bf),
             "kv_len 4096 sink above": ([4096] * 8, None, True, bf),
             "edges": ([0, 1, 4, 5, 6, 4097, 300, 5], None, False, bf),
             "window edges sink above": ([0, 1, 5, 132, 133, 256, 1000,
                                          4100], win, True, bf),
             "f32 window": ([0, 7, 133, 700], win, False, f32),
             "f32 kv_len 4096": ([4096, 4000, 17, 0], None, False, f32)}
    for tag, (lens, w, big, dtype) in cases.items():
        b = len(lens)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((b, s_rows, n, d), generator=gen, device=dev,
                        dtype=dtype)
        mp = -(-max(max(lens), 1) // ps)
        if w is None:
            pk, pv = _pools(torch, gen, dev, 2, b * mp, kvn, ps, d, dtype)
            clean = _tables(torch, dev, b, mp, dead_last=tag == "edges")
            dirty = clean
        else:
            pk, pv = _ring_pools(torch, gen, dev, b, r_ring, kvn, ps, d,
                                 dtype, False)
            clean = _ring_tables(torch, dev, b, r_ring, mp)
            dirty = _poisoned(torch, clean, kv - s_rows - w + 1, ps,
                              b * r_ring)
        sinks = _sink_draw(torch, gen, dev, n, big)

        def run(tb, q=q, pk=pk, pv=pv, kv=kv, w=w, sinks=sinks):
            return pd.paged_flash_verify(q, pk, pv, tb, kv, layer, window=w,
                                         sinks=sinks)

        def plain(q=q, pk=pk, pv=pv, clean=clean, kv=kv, w=w, sinks=sinks):
            return pd.paged_flash_verify_ref(q, pk, pv, clean, kv, layer,
                                             window=w, sinks=sinks)

        got, want = run(dirty), plain()
        torch.cuda.synchronize()
        span = mp * ps if not w else min(mp * ps, w + s_rows - 1)
        splits = pd.decode_splits(b, kvn, span, 2)
        dead = ([i for i in range(b) if lens[i] == 0]
                + ([b - 1] if tag == "edges" else []))
        ck, cv = gather_dense(pk[layer], pv[layer], clean)
        err = _sink_rule(
            torch, "paged_flash_verify sinks", f"{tag} (B={b} S={s_rows} "
            f"N={n} kvN={kvn} kv_lens {lens[:4]}.. window={w}, {splits} "
            f"splits, 2 row blocks)", got, want, big,
            _top_score(torch, q, ck.transpose(1, 2), scale), dead)
        require(not big or w or splits > 1,
                f"paged_flash_verify sinks {tag}: one split only")
        require(bool(torch.equal(got, run(clean))),
                f"paged_flash_verify sinks {tag}: a page below the window "
                f"band was read")
        if not tag.startswith("gpt-oss-20b"):
            del ck, cv, pk, pv
            continue
        keys, kv_rows = _verify_keys(lens, s_rows, w)
        es = q.element_size()
        bms, by = bound_ms(2 * b * s_rows * n * d * es
                           + 2 * kv_rows * kvn * d * es + clean.numel() * 4
                           + b * 4 + 4 * n, 4.0 * n * d * keys, "bfloat16")
        ck, cv = _gqa(torch, ck, n), _gqa(torch, cv, n)
        key_pos = torch.arange(ck.shape[2], device=dev)
        q_pos = (kv.long()[:, None] - s_rows
                 + torch.arange(s_rows, device=dev)[None])
        mask = key_pos[None, None] <= q_pos[:, :, None]
        if w:
            mask = mask & (key_pos[None, None] > q_pos[:, :, None] - w)
        mask = mask[:, None]
        qt = q.transpose(1, 2)
        row = ("paged_flash_verify_sinks" if w is None
               else "paged_flash_verify_window_sinks")
        results[row] = dict(
            max_abs_err=err, ms=time_ms(torch, lambda: run(clean)),
            plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, ck, cv, attn_mask=mask)),
            bound_ms=bms, bound_by=by, library=LIBRARY[row])
        del ck, cv, pk, pv

    # 13s, 13ws: (smax, lens, window, big sink, dtype); rows first
    dense_lens = [160 + 8 * i for i in range(8)]
    cases = {"gpt-oss-20b": (OSS_DENSE_SMAX, dense_lens, None, False, bf),
             "gpt-oss-20b window": (OSS_DENSE_SMAX, dense_lens, win, False,
                                    bf),
             "kv_len 4096 sink above": (4224, [4096] * 8, None, True, bf),
             "window kv_len 4096 sink above": (4224, [4096] * 8, win, True,
                                               bf),
             "edges": (OSS_DENSE_SMAX, [0, 1, 127, 128, 129, 255, 256, 3],
                       None, False, bf),
             "window edges sink above": (OSS_DENSE_SMAX, [0, 1, 127, 128,
                                                          129, 255, 256, 3],
                                         win, True, bf),
             "f32 window": (4224, [0, 7, 129, 4100], win, False, f32),
             "f32": (4224, [0, 7, 129, 4100], None, False, f32)}
    for tag, (smax, lens, w, big, dtype) in cases.items():
        b = len(lens)
        ck, cv = _arena(torch, gen, dev, 2, b + 1, kvn, smax, d, dtype)
        q = torch.randn((b, n, d), generator=gen, device=dev, dtype=dtype)
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        sinks = _sink_draw(torch, gen, dev, n, big)

        def run(q=q, ck=ck, cv=cv, kv=kv, w=w, sinks=sinks):
            return fd.flash_decode(q, ck, cv, kv, layer=layer, window=w,
                                   sinks=sinks)

        def plain(q=q, ck=ck, cv=cv, kv=kv, w=w, sinks=sinks):
            return fd.flash_decode_ref(q, ck, cv, kv, layer=layer, window=w,
                                       sinks=sinks)

        got, want = run(), plain()
        torch.cuda.synchronize()
        splits = pd.decode_splits(b, kvn, min(smax, w) if w else smax)
        err = _sink_rule(
            torch, "flash_decode sinks", f"{tag} (B={b} N={n} kvN={kvn} "
            f"D={d} Smax={smax} kv_lens {lens[:4]}.. window={w}, {splits} "
            f"splits)", got, want, big,
            _top_score(torch, q[:, None], ck[layer, :b].transpose(1, 2),
                       scale), [i for i in range(b) if lens[i] == 0])
        require(not big or w or splits > 1,
                f"flash_decode sinks {tag}: one split only")
        if not tag.startswith("gpt-oss-20b"):
            del ck, cv
            continue
        span = [min(ln, smax) - (max(0, ln - w) if w else 0) for ln in lens]
        es = q.element_size()
        bms, by = bound_ms(2 * b * n * d * es + 2 * sum(span) * kvn * d * es
                           + b * 4 + 4 * n, 4.0 * n * d * sum(span),
                           "bfloat16")
        top = max(lens)
        k4 = _gqa(torch, ck[layer, :b, :, :top], n)
        v4 = _gqa(torch, cv[layer, :b, :, :top], n)
        key_pos = torch.arange(top, device=dev)[None, None, None, :]
        mask = key_pos < kv.long()[:, None, None, None]
        if w:
            mask = mask & (key_pos >= kv.long()[:, None, None, None] - w)
        row = ("flash_decode_sinks" if w is None
               else "flash_decode_window_sinks")
        results[row] = dict(
            max_abs_err=err, ms=time_ms(torch, run),
            plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], k4, v4, attn_mask=mask)),
            bound_ms=bms, bound_by=by, library=LIBRARY[row])
        del ck, cv, k4, v4
    print(f"[kernels] gpt-oss-20b verify rows and dense arena: the sink "
          f"checks took {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()


GEMMA2_9B = dict(n=16, kvn=8, d=256)      # Gemma-2-9B's attention (cap 50)


def _e4m3_ring_pools(torch, gen, dev, b, r, kvn, ps, d):
    """Two layers of e4m3 ring pools (b x r pages), 4 pages of code 0x7f
    (NaN in e4m3fn) after them and the trash page."""
    pk, pv = _e4m3_pools(torch, gen, dev, 2, b * r + 4, kvn, ps, d)
    for p in (pk, pv):
        p.view(torch.uint8)[:, b * r:b * r + 4] = 0x7F
    return [pk, pv, None, None]


def _kv_options_attn(torch, dev, gen, kind, row, tag, shape, lens, *,
                 window=None, cap=None, sink=None, dtype=None, s=5,
                 sq=None, offs=None, q_x=1.0, dead=False, timed=False,
                 results=None, extra=None, kv_dtype="int8"):
    """One case of kernel 4's or 8's INT8-KV forms with sinks, the cap or
    at D 256 (or, ``kv_dtype`` "fp8", of their e4m3 forms with sinks and
    windows) against its plain version. ``kind``: "decode", "verify" (``s``
    rows a sequence) or "prefill" (``sq`` rows at ``offs``); ``shape``
    (n, kvn, d); ``lens`` the kv_lens. INT8 pools quantized from N(0, 1)
    rows (scales near 0.02, far from 1), e4m3 pools cast from them; with a
    ``window`` ring tables of the grouped engine's R whose columns below
    the band sit on pages with NaN scales (NaN codes over e4m3 pools; the
    kernel must read none of them: its output equals the clean tables');
    ``cap`` with q x ``q_x`` (scores past the cap);
    ``sink`` "n01" or "above" (a sink above every score, counted once where
    the walk splits); ``dead`` an all -1 last table row. Decode and verify
    by :func:`_rounding_rule` (rows without keys zero), prefill by
    :func:`_prefill_rule`, sinks by :func:`_sink_rule`. With ``timed``,
    the case fills ``row``'s result (kernel, plain version, bytes bound,
    and SDPA over the gathered K/V dequantized, or cast from e4m3, in the
    call, without sink or cap) and is added to ``extra``. Returns
    max|err|."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    from simplellminference_tpu_torch.ops.attention import paged_prefill as pp
    from simplellminference_tpu_torch.ops.attention import prefill_tiles
    dtype = dtype or torch.bfloat16
    n, kvn, d = shape
    b, ps, layer, scale = len(lens), 128, 1, d ** -0.5
    kv = torch.tensor(lens, dtype=torch.int32, device=dev)
    if kind == "prefill":
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        mp = -(-max(o + sq for o in offs) // ps)
        rows = sq
    else:
        mp = -(-max(max(lens), 1) // ps)
        rows = 1 if kind == "decode" else s
    fp8 = kv_dtype == "fp8"
    if window:
        r = (window + max(rows, 128) - 2) // ps + 2
        pk, pv, ks, vs = (
            _e4m3_ring_pools(torch, gen, dev, b, r, kvn, ps, d) if fp8
            else _ring_pools(torch, gen, dev, b, r, kvn, ps, d, dtype, True))
        clean = _ring_tables(torch, dev, b, r, mp)
        k_lo = (off - window + 1 if kind == "prefill"
                else kv - rows - window + 1)
        dirty = _poisoned(torch, clean, k_lo, ps, b * r)
    elif fp8:
        pk, pv = _e4m3_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        ks = vs = None
        clean = _tables(torch, dev, b, mp, dead_last=dead)
        dirty = clean
    else:
        pk, pv, ks, vs = _quant_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        clean = _tables(torch, dev, b, mp, dead_last=dead)
        dirty = clean
    require(pk.dtype == (torch.float8_e4m3fn if fp8 else torch.int8),
            f"{row} {tag}: {pk.dtype} pools, not the form's")
    qshape = (b, n, d) if kind == "decode" else (b, rows, n, d)
    q = (torch.randn(qshape, generator=gen, device=dev) * q_x).to(dtype)
    sinks = (None if sink is None
             else _sink_draw(torch, gen, dev, n, sink == "above"))
    opts = dict(window=window, logit_cap=cap, sinks=sinks, k_scale=ks,
                v_scale=vs)

    def run(tb):
        if kind == "decode":
            return pd.paged_flash_decode(q, pk, pv, tb, kv, layer, **opts)
        if kind == "verify":
            return pd.paged_flash_verify(q, pk, pv, tb, kv, layer, **opts)
        return pp.paged_flash_prefill(q, pk, pv, tb, kv, off, layer, **opts)

    def plain():
        if kind == "decode":
            return pd.paged_flash_decode_ref(q, pk, pv, clean, kv, layer,
                                             **opts)
        if kind == "verify":
            return pd.paged_flash_verify_ref(q, pk, pv, clean, kv, layer,
                                             **opts)
        return pp.paged_flash_prefill_ref(q, pk, pv, clean, kv, off, layer,
                                          **opts)

    got = run(dirty)
    want = plain()
    torch.cuda.synchronize()
    if kind == "prefill":
        splits = prefill_tiles.launch_splits(b, sq, n, kvn, window or 0,
                                             mp * ps)
    else:
        span = mp * ps if not window else min(mp * ps, window + rows - 1)
        splits = pd.decode_splits(b, kvn, span,
                                  pd.row_blocks((n // kvn) * rows))
    name = f"{row} ({kind})"
    text = (f"{tag} (B={b} N={n} kvN={kvn} D={d} rows={rows} "
            f"kv_lens {lens[:4]}.. window={window} cap={cap} sink={sink} "
            f"{dname(torch, dtype)}, {splits} splits)")
    def gathered():
        return gather_dense(pk[layer], pv[layer], clean,
                            None if fp8 else ks[layer],
                            None if fp8 else vs[layer])

    ck, cv = gathered()
    q4 = q[:, None] if kind == "decode" else q
    top = _top_score(torch, q4, ck.transpose(1, 2), scale)
    if kind == "prefill":
        zero = []
    else:
        zero = [i for i in range(b) if lens[i] <= 0] + ([b - 1] * dead)
    if sink is not None:
        err = _sink_rule(torch, name, text, got, want, sink == "above",
                         top, zero)
    elif kind == "prefill":
        ok, err, note = _prefill_rule(torch, got, want)
        print(f"[kernels] {name} {text}: max|err| {err:.3e} ({note}); "
              f"max|score| {top:.2f}", flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"{name} {text} disagrees: {err} ({note})")
    else:
        err = _attn_check(torch, name, text, got, want, zero)
    if cap:
        print(f"[kernels] {name} {tag}: max|score| {top:.1f} against the "
              f"cap {cap}", flush=True)
    if window:
        require(bool(torch.equal(got, run(clean))),
                f"{name} {text}: a page below the window band was read")
    if not timed:
        return err
    # the bytes: q in and out, each live key's int8 K and V rows and their
    # two scales (e4m3: the rows alone) once, the tables, kv_lens
    # (offsets), the sinks
    es = q.element_size()
    if kind == "prefill":
        keys = sum(min(o + i + 1, ln) - (max(0, o + i - window + 1)
                                          if window else 0)
                   for o, ln in zip(offs, lens) for i in range(sq)
                   if o + i < ln)
        kv_rows = sum(min(ln, o + sq) - (max(0, o - window + 1)
                                         if window else 0)
                      for o, ln in zip(offs, lens))
    else:
        pos = [(ln - rows + i) for ln in lens for i in range(rows)]
        keys = sum(min(p + 1, window or p + 1) for p in pos if p >= 0)
        kv_rows = sum(min(ln, window + rows - 1) if window else ln
                      for ln in lens)
    nbytes = (2 * q.numel() * es + kv_rows * kvn * 2 * (d + 4 * (not fp8))
              + clean.numel() * 4 + 2 * b * 4 + 4 * n)
    bms, by = bound_ms(nbytes, 4.0 * n * d * keys, dname(torch, dtype))
    key_pos = torch.arange(mp * ps, device=dev)
    if kind == "prefill":
        q_pos = off.long()[:, None] + torch.arange(sq, device=dev)[None]
    else:
        q_pos = (kv.long()[:, None] - rows
                 + torch.arange(rows, device=dev)[None])
    mask = ((key_pos[None, None] <= q_pos[:, :, None])
            & (key_pos[None, None] < kv.long()[:, None, None]))
    if window:
        mask = mask & (key_pos[None, None] > q_pos[:, :, None] - window)
    mask = mask[:, None]
    qt = q4.transpose(1, 2)

    def library():
        k, v = gathered()
        return F.scaled_dot_product_attention(
            qt, _gqa(torch, k.to(dtype), n), _gqa(torch, v.to(dtype), n),
            attn_mask=mask)

    res = dict(max_abs_err=err, ms=time_ms(torch, lambda: run(clean)),
               plain_ms=time_ms(torch, plain),
               library_ms=time_ms(torch, library), bound_ms=bms,
               bound_by=by, library=LIBRARY[row])
    extra.append((row, tag, res))
    results.setdefault(row, res)
    del ck, cv
    return err


def check_int8kv_options(torch, dev, results, extra):
    """Kernels 4 and 8 over INT8 KV with GPT-OSS's sinks, Gemma-2's soft
    cap and at Gemma's head_dim 256 (:func:`_kv_options_attn`), each timed
    at its path's shape (the row's first case):
    - gpt-oss-20b (64 q heads over 8 kv heads, D 64, window 128): 4qs and
      4qws at `gpt_oss_int8kv`'s decode (8 rows at kv_len 128-156), 4vqs
      and 4vqws at `gpt_oss_spec_int8kv`'s verify step (8 x 5 rows: two
      row blocks), 8qs and 8qws at its prefix chunks (256 rows at offset
      256, and at offset 512 over the ring); kv_len 4096 (4qs, 4vqs) and
      offset 4096 (8qs) with a sink above every score where the key walk
      splits, edges (kv_len 0, 1, a dead slot), ring tables with NaN-scale
      pages below the band, f32;
    - Gemma-2-2B (8 q heads over 4 kv heads, D 256, cap 50, window 4096)
      and Gemma-2-9B (16 over 8): 4qc/256, 4qwc/256, 4vqc/256, 4vqwc/256,
      8qc/256, 8qwc/256, scores past the cap (q x 60), windows of 100 over
      the ring at their edges, kv_len 0, f32, and at D 128 (32 over 8);
    - Gemma-1 (8 q heads over one kv head, D 256): 4q/256 at
      `gemma_int8kv_prefix`'s decode (8 rows at context ~600), 4vq/256 at
      its group of 8 x 5 rows (two row blocks), 8q/256 at its chunk and
      suffix batch, and the uncapped window forms 4qw/256, 4vqw/256,
      8qw/256 (no model runs them) over the ring;
    then 6q/256 and 9/256, 10/256 (:func:`check_int8kv_d256_writes`)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2121)
    f32 = torch.float32
    oss = (GPT_OSS["n"], GPT_OSS["kvn"], GPT_OSS["d"])
    win = GPT_OSS["window"]
    g2 = (GEMMA2["n"], GEMMA2["kvn"], GEMMA2["d"])
    g9 = (GEMMA2_9B["n"], GEMMA2_9B["kvn"], GEMMA2_9B["d"])
    g1 = (GEMMA["n"], GEMMA["kvn"], GEMMA["d"])
    d128 = (32, 8, 128)
    cap = GEMMA2["cap"]
    decode = [128 + 4 * i for i in range(8)]      # bench.py's context
    verify = [147 + 2 * i for i in range(8)]      # the spec paths'
    prefix = [576 + 4 * i for i in range(8)]      # the prefix traffic's
    edges = [0, 1, 63, 64, 65, 4095, 300, 5]
    w_edges = [0, 1, 99, 100, 101, 255, 700, 5]
    kw = dict(results=results, extra=extra)
    # (row, kind, tag, shape, lens, options); a row's first case is timed
    cases = [
        # gpt-oss-20b: sinks over INT8 KV
        ("paged_flash_decode_int8kv_sinks", "decode", "gpt-oss-20b", oss,
         decode, dict(sink="n01")),
        ("paged_flash_decode_int8kv_sinks", "decode",
         "kv_len 4096 sink above", oss, [4096] * 8, dict(sink="above")),
        ("paged_flash_decode_int8kv_sinks", "decode", "edges", oss, edges,
         dict(sink="n01", dead=True)),
        ("paged_flash_decode_int8kv_sinks", "decode", "f32", oss,
         [4096, 17, 0, 700], dict(sink="above", dtype=f32)),
        ("paged_flash_decode_int8kv_window_sinks", "decode",
         "gpt-oss-20b window", oss, decode, dict(sink="n01", window=win)),
        ("paged_flash_decode_int8kv_window_sinks", "decode",
         "window edges sink above", oss,
         [0, 1, 127, 128, 129, 255, 256, 1000],
         dict(sink="above", window=win)),
        ("paged_flash_verify_int8kv_sinks", "verify", "gpt-oss-20b 8 x 5",
         oss, verify, dict(sink="n01")),
        ("paged_flash_verify_int8kv_sinks", "verify",
         "kv_len 4096 sink above", oss, [4096, 4000, 5, 4, 1, 0, 300, 2000],
         dict(sink="above")),
        ("paged_flash_verify_int8kv_sinks", "verify", "f32", oss,
         [4096, 17, 0, 5], dict(sink="n01", dtype=f32)),
        ("paged_flash_verify_int8kv_window_sinks", "verify",
         "gpt-oss-20b 8 x 5 window", oss, verify,
         dict(sink="n01", window=win)),
        ("paged_flash_verify_int8kv_window_sinks", "verify",
         "window edges sink above", oss, [0, 4, 5, 132, 133, 700, 4100, 9],
         dict(sink="above", window=win)),
        ("paged_flash_prefill_int8kv_sinks", "prefill",
         "gpt-oss-20b chunk", oss, [512], dict(sink="n01", sq=256,
                                               offs=[256])),
        ("paged_flash_prefill_int8kv_sinks", "prefill", "split sink above",
         oss, [4160], dict(sink="above", sq=64, offs=[4096])),
        ("paged_flash_prefill_int8kv_sinks", "prefill", "f32 ragged", oss,
         [100, 300, 77, 1], dict(sink="n01", sq=100, offs=[0, 256, 16, 0],
                                 dtype=f32)),
        ("paged_flash_prefill_int8kv_window_sinks", "prefill",
         "gpt-oss-20b window chunk", oss, [576],
         dict(sink="n01", window=win, sq=256, offs=[512])),
        ("paged_flash_prefill_int8kv_window_sinks", "prefill",
         "window ragged sink above", oss, [640, 1100, 60],
         dict(sink="above", window=win, sq=128, offs=[512, 1024, 0])),
        # Gemma-2: the cap over INT8 KV at D 256 (and D 128)
        ("paged_flash_decode_int8kv_cap_d256", "decode",
         "gemma-2-2b past the cap", g2, decode, dict(cap=cap, q_x=60.0)),
        ("paged_flash_decode_int8kv_cap_d256", "decode",
         "kv_len 4096 past the cap", g2, [4096] * 8,
         dict(cap=cap, q_x=60.0, timed=True)),
        ("paged_flash_decode_int8kv_cap_d256", "decode", "edges f32", g2,
         edges, dict(cap=cap, q_x=60.0, dead=True, dtype=f32)),
        ("paged_flash_decode_int8kv_cap_d256", "decode", "D 128", d128,
         decode, dict(cap=cap, q_x=60.0, timed=True)),
        ("paged_flash_decode_int8kv_window_cap_d256", "decode",
         "gemma-2-2b window", g2, decode,
         dict(cap=cap, q_x=60.0, window=WINDOW)),
        ("paged_flash_decode_int8kv_window_cap_d256", "decode",
         "window 100 edges", g2, w_edges,
         dict(cap=cap, q_x=60.0, window=100)),
        ("paged_flash_decode_int8kv_window_cap_d256", "decode",
         "D 128 window 100", d128, w_edges,
         dict(cap=cap, q_x=60.0, window=100, timed=True)),
        ("paged_flash_verify_int8kv_cap_d256", "verify",
         "gemma-2-2b 8 x 5 past the cap", g2, verify,
         dict(cap=cap, q_x=60.0)),
        ("paged_flash_verify_int8kv_cap_d256", "verify",
         "gemma-2-9b 8 x 5", g9, verify, dict(cap=cap, q_x=60.0,
                                              timed=True)),
        ("paged_flash_verify_int8kv_cap_d256", "verify", "f32 edges", g2,
         [4096, 5, 4, 0], dict(cap=cap, q_x=60.0, dtype=f32)),
        ("paged_flash_verify_int8kv_cap_d256", "verify", "D 128", d128,
         verify, dict(cap=cap, q_x=60.0, timed=True)),
        ("paged_flash_verify_int8kv_window_cap_d256", "verify",
         "gemma-2-2b 8 x 5 window", g2, verify,
         dict(cap=cap, q_x=60.0, window=WINDOW)),
        ("paged_flash_verify_int8kv_window_cap_d256", "verify",
         "window 100 edges", g2, [0, 4, 5, 104, 105, 700, 4100, 9],
         dict(cap=cap, q_x=60.0, window=100)),
        ("paged_flash_verify_int8kv_window_cap_d256", "verify",
         "D 128 window 100", d128, [0, 4, 5, 104, 105, 700, 4100, 9],
         dict(cap=cap, q_x=60.0, window=100, timed=True)),
        ("paged_flash_prefill_int8kv_cap_d256", "prefill",
         "gemma-2-2b chunk past the cap", g2, [512],
         dict(cap=cap, q_x=60.0, sq=256, offs=[256])),
        ("paged_flash_prefill_int8kv_cap_d256", "prefill", "f32 ragged", g2,
         [100, 300, 77, 1], dict(cap=cap, q_x=60.0, sq=100,
                                 offs=[0, 256, 16, 0], dtype=f32)),
        ("paged_flash_prefill_int8kv_cap_d256", "prefill", "D 128 chunk",
         d128, [512], dict(cap=cap, q_x=60.0, sq=256, offs=[256],
                           timed=True)),
        ("paged_flash_prefill_int8kv_window_cap_d256", "prefill",
         "gemma-2-2b window chunk", g2, [576],
         dict(cap=cap, q_x=60.0, window=WINDOW, sq=256, offs=[512])),
        ("paged_flash_prefill_int8kv_window_cap_d256", "prefill",
         "window 100 ragged", g2, [640, 1100, 60],
         dict(cap=cap, q_x=60.0, window=100, sq=128, offs=[512, 1024, 0])),
        ("paged_flash_prefill_int8kv_window_cap_d256", "prefill",
         "D 128 window 100", d128, [640, 1100, 60],
         dict(cap=cap, q_x=60.0, window=100, sq=128, offs=[512, 1024, 0],
              timed=True)),
        # Gemma-1: INT8 KV at D 256 (the window forms on no path)
        ("paged_flash_decode_int8kv_d256", "decode", "gemma-2b prefix", g1,
         prefix, dict()),
        ("paged_flash_decode_int8kv_d256", "decode", "kv_len 4096", g1,
         [4096] * 8, dict(timed=True)),
        ("paged_flash_decode_int8kv_d256", "decode", "edges f32", g1, edges,
         dict(dead=True, dtype=f32)),
        ("paged_flash_decode_int8kv_window_d256", "decode",
         "gemma-2b window 100", g1, w_edges, dict(window=100)),
        ("paged_flash_verify_int8kv_d256", "verify", "gemma-2b 8 x 5", g1,
         verify, dict()),
        ("paged_flash_verify_int8kv_d256", "verify", "kv_len 4096 f32", g1,
         [4096, 5, 4, 0], dict(dtype=f32)),
        ("paged_flash_verify_int8kv_window_d256", "verify",
         "gemma-2b 8 x 5 window 100", g1, [0, 4, 5, 104, 105, 700, 4100, 9],
         dict(window=100)),
        ("paged_flash_prefill_int8kv_d256", "prefill", "gemma-2b chunk", g1,
         [512], dict(sq=256, offs=[256])),
        ("paged_flash_prefill_int8kv_d256", "prefill",
         "gemma-2b suffix batch", g1, [540 + 5 * i for i in range(8)],
         dict(sq=64, offs=[512] * 8, timed=True)),
        ("paged_flash_prefill_int8kv_d256", "prefill", "f32 ragged", g1,
         [100, 300, 77, 1], dict(sq=100, offs=[0, 256, 16, 0], dtype=f32)),
        ("paged_flash_prefill_int8kv_window_d256", "prefill",
         "gemma-2b window 100", g1, [640, 1100, 60],
         dict(window=100, sq=128, offs=[512, 1024, 0])),
    ]
    seen = set()
    for row, kind, tag, shape, lens, opts in cases:
        timed = opts.pop("timed", False) or row not in seen
        seen.add(row)
        _kv_options_attn(torch, dev, gen, kind, row, tag, shape, lens,
                     timed=timed, **opts, **kw)
        torch.cuda.empty_cache()
    check_int8kv_d256_writes(torch, dev, results, extra)
    print(f"[kernels] INT8 KV with sinks, the cap and at D 256: the checks "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)


def check_int8kv_d256_writes(torch, dev, results, extra):
    """The quantizing writes 9 and 10 at D 256 (Gemma-2-2B's 4 kv heads:
    8 decode rows, 8 x 128 prompt rows and a ragged batch; bf16 and f32
    rows) byte-equal to their plain versions, and the quantizing fused qkv
    6q at D 256: Gemma-2B (H 2048, 8 q heads over one kv head; 8 bf16
    rows on 6m, the row; f32 rows on the FMA kernel) and Gemma-2-2B (H
    2304, 4 kv heads) with a kv_layer (the grouped engine's INT8 ring
    pools), an unmapped row: codes at most one apart, scales within one
    bf16 ulp of the absmax / 127 (F32_REL in f32), q by the fused rule,
    every other entry equal; each bf16 case also captured in a CUDA graph
    and replayed three times, eager calls between, bit for bit (the K
    split's arrival counters reset, the quantizing launch in the graph).
    Timed beside the plain version, the bytes bound and the library call
    (quantize ops + index_put_, torch._weight_int8pack_mm of the product
    alone)."""
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.paged_append import (
        paged_append_decode_quant, paged_append_decode_quant_ref,
        paged_append_prefill_quant, paged_append_prefill_quant_ref)
    from simplellminference_tpu_torch.ops.qkv_fused import (
        fused_qkv_append, fused_qkv_append_ref)
    gen = torch.Generator(device=dev).manual_seed(2122)
    bf, f32 = torch.bfloat16, torch.float32
    kvn, d, ps = GEMMA2["kvn"], 256, 128
    # 9/256 and 10/256
    for tag, (b, s, dtype) in {"gemma-2-2b decode": (8, 1, bf),
                               "gemma-2-2b prefill": (8, 128, bf),
                               "ragged f32": (4, 100, f32)}.items():
        mp = 3
        pools = _quant_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        qkv = torch.randn((b, s, 3 * kvn * d), generator=gen, device=dev,
                          dtype=dtype) * 4
        nk = qkv[..., kvn * d:2 * kvn * d].reshape(b, s, kvn, d)
        nv = qkv[..., 2 * kvn * d:].reshape(b, s, kvn, d)
        tables = _tables(torch, dev, b, mp)
        pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
        if s == 1:
            row = "paged_append_decode_quant_d256"
            args = (nk[:, 0], nv[:, 0], tables, pos, 1)
            kern, plain = (paged_append_decode_quant,
                           paged_append_decode_quant_ref)
        else:
            row = "paged_append_prefill_quant_d256"
            args = (nk, nv, tables, 0)
            kern, plain = (paged_append_prefill_quant,
                           paged_append_prefill_quant_ref)
        a, r = [p.clone() for p in pools], [p.clone() for p in pools]
        kern(*a, *args)
        plain(*r, *args)
        torch.cuda.synchronize()
        err = max(max_err(x[:, :-1], y[:, :-1]) for x, y in zip(a, r))
        print(f"[kernels] {row} {tag} (B={b} S={s} kvN={kvn} D={d} "
              f"{dname(torch, dtype)}): codes and scales max|err| {err} "
              f"(tol 0, byte-equal; trash page excluded)", flush=True)
        require(err == 0.0, f"{row} {tag} disagrees: {err}")
        if row in results:
            continue
        npg = -(-s // ps)
        p1 = pools[0].shape[1]
        if s == 1:
            page = tables.long().gather(1, (pos.long() // ps)[:, None])[:, 0]
            page = torch.where(page >= 0, page, p1 - 1)
            ix = (page[:, None], torch.arange(kvn, device=dev)[None],
                  (pos.long() % ps)[:, None])

            def library(a=a, nk=nk, nv=nv, ix=ix):
                for pool, sc, x in ((a[0], a[2], nk[:, 0]),
                                    (a[1], a[3], nv[:, 0])):
                    q, sq = _quantize_lib(torch, x)
                    pool[1].index_put_(ix, q)
                    sc[1].index_put_(ix, sq)
        else:
            idx = tables[:, :npg].long()
            idx = torch.where(idx >= 0, idx, p1 - 1).reshape(-1)

            def library(a=a, nk=nk, nv=nv, idx=idx, b=b, npg=npg):
                for pool, sc, x in ((a[0], a[2], nk), (a[1], a[3], nv)):
                    q, sq = _quantize_lib(torch, x)
                    pool[0].index_copy_(0, idx, q.reshape(
                        b, npg, ps, kvn, d).transpose(2, 3).reshape(
                            b * npg, kvn, ps, d))
                    sc[0].index_copy_(0, idx, sq.reshape(
                        b, npg, ps, kvn).transpose(2, 3).reshape(
                            b * npg, kvn, ps))

        es = nk.element_size()
        nbytes = (2 * b * s * kvn * d * es
                  + 2 * b * npg * (ps if s > 1 else 1) * kvn * (d + 4)
                  + tables.numel() * 4 + b * 4)
        bms, by = bound_ms(nbytes, 0.0, dname(torch, dtype))
        res = dict(max_abs_err=err,
                   ms=time_ms(torch, lambda: kern(*a, *args)),
                   plain_ms=time_ms(torch, lambda: plain(*r, *args)),
                   library_ms=time_ms(torch, library), bound_ms=bms,
                   bound_by=by, library=LIBRARY[row])
        results[row] = res
        extra.append((row, tag, res))

    # 6q/256, with and without a kv_layer
    for tag, (b, h, n, kvh, xdt, kv_layer, row) in {
            "gemma-2b": (8, 2048, 8, 1, bf, None,
                         "fused_qkv_append_int8kv_d256"),
            "gemma-2b f32 (fma)": (8, 2048, 8, 1, f32, None, None),
            "gemma-2-2b kv_layer": (8, 2304, 8, kvn, bf, 0,
                                    "fused_qkv_append_int8kv_kv_layer_d256"),
            "gemma-2-2b kv_layer m3": (3, 2304, 8, kvn, bf, 0, None)}.items():
        mp, layer = 6, 1
        kli = layer if kv_layer is None else kv_layer
        nq = (n + 2 * kvh) * d
        wq, ws = _qweight(torch, gen, dev, (2, h, nq), 1)
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(xdt)
        x = torch.randn((b, h), generator=gen, device=dev).to(xdt)
        pools = _quant_pools(torch, gen, dev, 2, b * mp, kvh, ps, d)
        tables = _tables(torch, dev, b, mp, dead_last=False)
        pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
        tables[-1, int(pos[-1]) // ps] = -1      # the trash page
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        kw = dict(n_heads=n, kv_heads=kvh, tables=tables, kv_layer=kv_layer)
        a, r = [p.clone() for p in pools], [p.clone() for p in pools]

        def call(p=a, x=x, nw=nw, wq=wq, ws=ws, sin=sin, cos=cos, kw=kw,
                 pos=pos):
            return fused_qkv_append(x, nw, wq, ws, sin, cos, p[0], p[1],
                                    layer, pos, cache_ks=p[2],
                                    cache_vs=p[3], **kw)[0]

        qa = call()
        qr = fused_qkv_append_ref(x, nw, wq, ws, sin, cos, r[0], r[1],
                                  layer, pos, cache_ks=r[2], cache_vs=r[3],
                                  **kw)[0]
        torch.cuda.synchronize()
        page = tables.long()[torch.arange(b, device=dev), pos.long() // ps]
        page = torch.where(page >= 0, page, pools[0].shape[1] - 1)
        written = torch.zeros(pools[2].shape, dtype=torch.bool, device=dev)
        written[kli, page, :, pos.long() % ps] = True
        err = max_err(qa, qr)
        lim_q = (F32_REL * float(qr.abs().max()) if xdt == f32
                 else TOL["bfloat16"] * float(qr.float().std()))
        code_d = max(int((ta[written].int() - tr[written].int()).abs().max())
                     for ta, tr in zip(a[:2], r[:2]))
        if xdt == f32:
            s_ok = all(bool(((sa[written] - sr[written]).abs()
                             <= F32_REL * sr[written]).all())
                       for sa, sr in zip(a[2:], r[2:]))
        else:
            s_ok = all(bool(((sa[written] - sr[written]).abs()
                             <= _bf16_ulp(torch, sr[written] * 127.0)
                             / 127.0 * (1 + 1e-6)).all())
                       for sa, sr in zip(a[2:], r[2:]))
        untouched = all(torch.equal(ta[~written], tr[~written])
                        for ta, tr in zip(a, r))
        replay = None
        if xdt == bf:
            # the captured call, replayed, and eager calls between
            b_pools = [p.clone() for p in a]
            eager = call(b_pools)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = call(b_pools)
            replay = True
            for _ in range(3):
                graph.replay()
                torch.cuda.synchronize()
                replay = replay and bool(torch.equal(out, eager))
                replay = replay and bool(torch.equal(call(b_pools), eager))
            replay = replay and all(torch.equal(x_b, x_a) for x_b, x_a in
                                    zip(b_pools, a))
            del graph
        print(f"[kernels] fused_qkv_append_int8kv/256 {tag} (B={b} H={h} "
              f"N={n} kvN={kvh} kv_layer={kv_layer}): q max|err| {err:.3e} "
              f"(tol {lim_q:.3e}); codes at most {code_d} apart (tol 1); "
              f"scales within the rule: {s_ok}; other entries equal: "
              f"{untouched}; graph replay bit-equal: {replay}", flush=True)
        require(bool(torch.isfinite(qa).all()) and err <= lim_q
                and code_d <= 1 and s_ok and untouched
                and replay is not False,
                f"fused_qkv_append_int8kv/256 {tag} disagrees: {err}, "
                f"{code_d}, {s_ok}, {untouched}, {replay}")
        if row is None:
            continue
        nbytes = _qkv_nbytes(h, nq, b, n, kvh, d, x.element_size(),
                             nw.element_size(), d + 4,
                             tables.numel() * 4 + b * 4)
        bms, by = bound_ms(nbytes, 2.0 * b * h * nq, dname(torch, xdt))
        qt, st = _int8pack(torch, wq[layer], ws[layer], xdt)
        res = dict(
            max_abs_err=max(err, float(code_d)), ms=time_ms(torch, call),
            plain_ms=time_ms(torch, lambda: fused_qkv_append_ref(
                x, nw, wq, ws, sin, cos, r[0], r[1], layer, pos,
                cache_ks=r[2], cache_vs=r[3], **kw)),
            library_ms=time_ms(torch, lambda: torch._weight_int8pack_mm(
                x, qt, st)),
            bound_ms=bms, bound_by=by, library=LIBRARY[row])
        results[row] = res
        extra.append((row, tag, res))


MISTRAL = dict(n=32, kvn=8, d=128)   # ModelConfig.mistral_7b's attention


def check_fp8kv_options(torch, dev, results, extra):
    """Kernels 4 and 8 over e4m3 pools with GPT-OSS's sinks and sliding
    windows (:func:`_kv_options_attn` with ``kv_dtype="fp8"``), each timed
    at its path's shape (the row's first case) beside SDPA over K/V cast
    from e4m3 in the call, without sinks:
    - gpt-oss-20b (64 q heads over 8 kv heads, D 64, window 128): 4es and
      4ews at `gpt_oss_fp8kv`'s decode (8 rows at kv_len 128-156), 4ves
      and 4vews at `gpt_oss_spec_fp8kv`'s verify step (8 x 5 rows: two row
      blocks), 8es and 8ews at its prefix chunks (256 rows at offset 256,
      and at offset 512 over the ring); kv_len 4096 (4es, 4ves) and
      offset 4096 (8es) with a sink above every score where the key walk
      splits, edges (kv_len 0, 1, a dead slot), ring tables with pages of
      NaN codes below the band, f32;
    - Mistral-7B (32 q heads over 8 kv heads, D 128, window 4096): 4ew,
      4vew and 8ew over ring tables of the grouped engine's R (decode and
      verify past the window, the 256-row chunk at offset 4096), and
      windows of 100 at their edges in f32;
    - Gemma-2-2B (8 q heads over 4 kv heads, D 256, cap 50, window 4096)
      and Gemma-2-9B (16 over 8): 4ec/256, 4ewc/256, 4vec/256, 4vewc/256,
      8ec/256, 8ewc/256, scores past the cap (q x 60), windows of 100 over
      the ring at their edges, kv_len 0, f32, and at D 128 (32 over 8),
      each beside SDPA over K/V cast in the call without the cap;
    - Gemma-1 (8 q heads over one kv head, D 256): 4e/256 at
      `gemma_fp8kv_prefix`'s decode (8 rows at context ~600), 4ve/256 at
      its group of 8 x 5 rows (two row blocks), 8e/256 at its chunk and
      suffix batch, and the uncapped window forms 4ew/256, 4vew/256,
      8ew/256 (no model runs them) over the ring;
    then 1e, 2e, 11e, 6e and 6ek at D 256
    (:func:`check_fp8kv_d256_writes`)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2323)
    f32 = torch.float32
    oss = (GPT_OSS["n"], GPT_OSS["kvn"], GPT_OSS["d"])
    win = GPT_OSS["window"]
    mis = (MISTRAL["n"], MISTRAL["kvn"], MISTRAL["d"])
    g2 = (GEMMA2["n"], GEMMA2["kvn"], GEMMA2["d"])
    g9 = (GEMMA2_9B["n"], GEMMA2_9B["kvn"], GEMMA2_9B["d"])
    g1 = (GEMMA["n"], GEMMA["kvn"], GEMMA["d"])
    d128 = (32, 8, 128)
    cap = GEMMA2["cap"]
    decode = [128 + 4 * i for i in range(8)]      # bench.py's context
    verify = [147 + 2 * i for i in range(8)]      # the spec paths'
    prefix = [576 + 4 * i for i in range(8)]      # the prefix traffic's
    long = [4224 + 40 * i for i in range(8)]      # Mistral past its window
    edges = [0, 1, 63, 64, 65, 4095, 300, 5]
    w_edges = [0, 1, 99, 100, 101, 255, 700, 5]
    v_edges = [0, 4, 5, 104, 105, 700, 4100, 9]
    kw = dict(results=results, extra=extra, kv_dtype="fp8")
    # (row, kind, tag, shape, lens, options); a row's first case is timed
    cases = [
        # gpt-oss-20b: sinks over e4m3 pools
        ("paged_flash_decode_fp8kv_sinks", "decode", "gpt-oss-20b", oss,
         decode, dict(sink="n01")),
        ("paged_flash_decode_fp8kv_sinks", "decode",
         "kv_len 4096 sink above", oss, [4096] * 8, dict(sink="above")),
        ("paged_flash_decode_fp8kv_sinks", "decode", "edges", oss, edges,
         dict(sink="n01", dead=True)),
        ("paged_flash_decode_fp8kv_sinks", "decode", "f32", oss,
         [4096, 17, 0, 700], dict(sink="above", dtype=f32)),
        ("paged_flash_decode_fp8kv_window_sinks", "decode",
         "gpt-oss-20b window", oss, decode, dict(sink="n01", window=win)),
        ("paged_flash_decode_fp8kv_window_sinks", "decode",
         "window edges sink above", oss,
         [0, 1, 127, 128, 129, 255, 256, 1000],
         dict(sink="above", window=win)),
        ("paged_flash_verify_fp8kv_sinks", "verify", "gpt-oss-20b 8 x 5",
         oss, verify, dict(sink="n01")),
        ("paged_flash_verify_fp8kv_sinks", "verify",
         "kv_len 4096 sink above", oss, [4096, 4000, 5, 4, 1, 0, 300, 2000],
         dict(sink="above")),
        ("paged_flash_verify_fp8kv_sinks", "verify", "f32", oss,
         [4096, 17, 0, 5], dict(sink="n01", dtype=f32)),
        ("paged_flash_verify_fp8kv_window_sinks", "verify",
         "gpt-oss-20b 8 x 5 window", oss, verify,
         dict(sink="n01", window=win)),
        ("paged_flash_verify_fp8kv_window_sinks", "verify",
         "window edges sink above f32", oss,
         [0, 4, 5, 132, 133, 700, 4100, 9],
         dict(sink="above", window=win, dtype=f32)),
        ("paged_flash_prefill_fp8kv_sinks", "prefill",
         "gpt-oss-20b chunk", oss, [512], dict(sink="n01", sq=256,
                                               offs=[256])),
        ("paged_flash_prefill_fp8kv_sinks", "prefill", "split sink above",
         oss, [4160], dict(sink="above", sq=64, offs=[4096])),
        ("paged_flash_prefill_fp8kv_sinks", "prefill", "f32 ragged", oss,
         [100, 300, 77, 1], dict(sink="n01", sq=100, offs=[0, 256, 16, 0],
                                 dtype=f32)),
        ("paged_flash_prefill_fp8kv_window_sinks", "prefill",
         "gpt-oss-20b window chunk", oss, [576],
         dict(sink="n01", window=win, sq=256, offs=[512])),
        ("paged_flash_prefill_fp8kv_window_sinks", "prefill",
         "window ragged sink above", oss, [640, 1100, 60],
         dict(sink="above", window=win, sq=128, offs=[512, 1024, 0])),
        # Mistral-7B: the window over e4m3 ring pools
        ("paged_flash_decode_fp8kv_window", "decode",
         "mistral-7b past the window", mis, long, dict(window=WINDOW)),
        ("paged_flash_decode_fp8kv_window", "decode", "window 100 edges f32",
         mis, [0, 1, 99, 100, 101, 255, 700, 5],
         dict(window=100, dtype=f32)),
        ("paged_flash_verify_fp8kv_window", "verify",
         "mistral-7b 8 x 5 past the window", mis, long, dict(window=WINDOW)),
        ("paged_flash_verify_fp8kv_window", "verify", "window 100 edges f32",
         mis, [0, 4, 5, 104, 105, 700, 4100, 9],
         dict(window=100, dtype=f32)),
        ("paged_flash_prefill_fp8kv_window", "prefill",
         "mistral-7b chunk past the window", mis, [4352],
         dict(window=WINDOW, sq=MISTRAL_CHUNK, offs=[4096])),
        ("paged_flash_prefill_fp8kv_window", "prefill",
         "window 100 ragged f32", mis, [640, 1100, 60],
         dict(window=100, sq=128, offs=[512, 1024, 0], dtype=f32)),
        # Gemma-2: the cap over e4m3 pools at D 256 (and D 128)
        ("paged_flash_decode_fp8kv_cap_d256", "decode",
         "gemma-2-2b past the cap", g2, decode, dict(cap=cap, q_x=60.0)),
        ("paged_flash_decode_fp8kv_cap_d256", "decode",
         "kv_len 4096 past the cap", g2, [4096] * 8,
         dict(cap=cap, q_x=60.0)),
        ("paged_flash_decode_fp8kv_cap_d256", "decode", "edges f32", g2,
         edges, dict(cap=cap, q_x=60.0, dead=True, dtype=f32)),
        ("paged_flash_decode_fp8kv_cap_d256", "decode", "D 128", d128,
         decode, dict(cap=cap, q_x=60.0)),
        ("paged_flash_decode_fp8kv_window_cap_d256", "decode",
         "gemma-2-2b window", g2, decode,
         dict(cap=cap, q_x=60.0, window=WINDOW)),
        ("paged_flash_decode_fp8kv_window_cap_d256", "decode",
         "window 100 edges", g2, w_edges,
         dict(cap=cap, q_x=60.0, window=100)),
        ("paged_flash_decode_fp8kv_window_cap_d256", "decode",
         "D 128 window 100", d128, w_edges,
         dict(cap=cap, q_x=60.0, window=100)),
        ("paged_flash_verify_fp8kv_cap_d256", "verify",
         "gemma-2-2b 8 x 5 past the cap", g2, verify,
         dict(cap=cap, q_x=60.0)),
        ("paged_flash_verify_fp8kv_cap_d256", "verify",
         "gemma-2-9b 8 x 5", g9, verify, dict(cap=cap, q_x=60.0)),
        ("paged_flash_verify_fp8kv_cap_d256", "verify", "f32 edges", g2,
         [4096, 5, 4, 0], dict(cap=cap, q_x=60.0, dtype=f32)),
        ("paged_flash_verify_fp8kv_cap_d256", "verify", "D 128", d128,
         verify, dict(cap=cap, q_x=60.0)),
        ("paged_flash_verify_fp8kv_window_cap_d256", "verify",
         "gemma-2-2b 8 x 5 window", g2, verify,
         dict(cap=cap, q_x=60.0, window=WINDOW)),
        ("paged_flash_verify_fp8kv_window_cap_d256", "verify",
         "window 100 edges", g2, v_edges,
         dict(cap=cap, q_x=60.0, window=100)),
        ("paged_flash_verify_fp8kv_window_cap_d256", "verify",
         "D 128 window 100", d128, v_edges,
         dict(cap=cap, q_x=60.0, window=100)),
        ("paged_flash_prefill_fp8kv_cap_d256", "prefill",
         "gemma-2-2b chunk past the cap", g2, [512],
         dict(cap=cap, q_x=60.0, sq=256, offs=[256])),
        ("paged_flash_prefill_fp8kv_cap_d256", "prefill", "f32 ragged", g2,
         [100, 300, 77, 1], dict(cap=cap, q_x=60.0, sq=100,
                                 offs=[0, 256, 16, 0], dtype=f32)),
        ("paged_flash_prefill_fp8kv_cap_d256", "prefill", "D 128 chunk",
         d128, [512], dict(cap=cap, q_x=60.0, sq=256, offs=[256])),
        ("paged_flash_prefill_fp8kv_window_cap_d256", "prefill",
         "gemma-2-2b window chunk", g2, [576],
         dict(cap=cap, q_x=60.0, window=WINDOW, sq=256, offs=[512])),
        ("paged_flash_prefill_fp8kv_window_cap_d256", "prefill",
         "window 100 ragged", g2, [640, 1100, 60],
         dict(cap=cap, q_x=60.0, window=100, sq=128, offs=[512, 1024, 0])),
        ("paged_flash_prefill_fp8kv_window_cap_d256", "prefill",
         "D 128 window 100", d128, [640, 1100, 60],
         dict(cap=cap, q_x=60.0, window=100, sq=128, offs=[512, 1024, 0])),
        # Gemma-1: e4m3 pools at D 256 (the window forms on no path)
        ("paged_flash_decode_fp8kv_d256", "decode", "gemma-2b prefix", g1,
         prefix, dict()),
        ("paged_flash_decode_fp8kv_d256", "decode", "kv_len 4096", g1,
         [4096] * 8, dict(timed=True)),
        ("paged_flash_decode_fp8kv_d256", "decode", "edges f32", g1, edges,
         dict(dead=True, dtype=f32)),
        ("paged_flash_decode_fp8kv_window_d256", "decode",
         "gemma-2b window 100", g1, w_edges, dict(window=100)),
        ("paged_flash_verify_fp8kv_d256", "verify", "gemma-2b 8 x 5", g1,
         verify, dict()),
        ("paged_flash_verify_fp8kv_d256", "verify", "kv_len 4096 f32", g1,
         [4096, 5, 4, 0], dict(dtype=f32)),
        ("paged_flash_verify_fp8kv_window_d256", "verify",
         "gemma-2b 8 x 5 window 100", g1, v_edges, dict(window=100)),
        ("paged_flash_prefill_fp8kv_d256", "prefill",
         "gemma-2b suffix batch", g1, [540 + 5 * i for i in range(8)],
         dict(sq=64, offs=[512] * 8)),
        ("paged_flash_prefill_fp8kv_d256", "prefill", "gemma-2b chunk", g1,
         [512], dict(sq=256, offs=[256])),
        ("paged_flash_prefill_fp8kv_d256", "prefill", "f32 ragged", g1,
         [100, 300, 77, 1], dict(sq=100, offs=[0, 256, 16, 0], dtype=f32)),
        ("paged_flash_prefill_fp8kv_window_d256", "prefill",
         "gemma-2b window 100", g1, [640, 1100, 60],
         dict(window=100, sq=128, offs=[512, 1024, 0])),
    ]
    seen = set()
    for row, kind, tag, shape, lens, opts in cases:
        timed = opts.pop("timed", False) or row not in seen
        seen.add(row)
        _kv_options_attn(torch, dev, gen, kind, row, tag, shape, lens,
                     timed=timed, **opts, **kw)
        torch.cuda.empty_cache()
    check_fp8kv_d256_writes(torch, dev, results, extra)
    print(f"[kernels] FP8 KV with sinks, windows, the cap and at D 256: the "
          f"checks took {time.perf_counter() - t0:.1f} s", flush=True)


def check_fp8kv_d256_writes(torch, dev, results, extra):
    """The e4m3 writes 1e, 2e and 11e at D 256 (Gemma-2-2B's 4 kv heads:
    8 decode rows, 8 x 128 prompt rows and a ragged f32 batch, spans of 5
    across a page; rows past 464) byte-equal to their plain versions, and
    the fused qkv into e4m3 pools at D 256: 6e/256 at Gemma-2B (H 2048, 8
    q heads over one kv head; 8 bf16 rows on 6m, the row; f32 rows on the
    FMA kernel) and 6ek/256 at Gemma-2-2B (H 2304, 4 kv heads, e4m3 ring
    pools at kv_layer 0): a head's columns lie in two blocks, each writing
    its own codes, held to the plain version's bytes (codes at most one
    step apart, the number apart printed), q by the fused rule, every
    other byte equal. Timed beside the plain version, the bytes bound and
    the library call (PyTorch's e4m3 cast + index_put_ / index_copy_;
    torch._weight_int8pack_mm of the product alone)."""
    from simplellminference_tpu_torch.ops import paged_append as pa
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.qkv_fused import (
        fused_qkv_append, fused_qkv_append_ref)
    gen = torch.Generator(device=dev).manual_seed(2424)
    bf, f32 = torch.bfloat16, torch.float32
    kvn, d, ps, layer = GEMMA2["kvn"], 256, 128, 1
    # 1e/256, 2e/256 and 11e/256: (row, kernel, plain, b, s, row dtype)
    for tag, (row, kern, plain, b, s, dtype) in {
            "gemma-2-2b decode": ("paged_append_decode_fp8kv_d256",
                                  pa.paged_append_decode,
                                  pa.paged_append_decode_ref, 8, 0, bf),
            "gemma-2-2b prefill": ("paged_append_prefill_fp8kv_d256",
                                   pa.paged_append_prefill,
                                   pa.paged_append_prefill_ref, 8, 128, bf),
            "ragged f32": ("paged_append_prefill_fp8kv_d256",
                           pa.paged_append_prefill,
                           pa.paged_append_prefill_ref, 4, 100, f32),
            "gemma-2-2b span 5": ("paged_append_span_fp8kv_d256",
                                  pa.paged_append_span,
                                  pa.paged_append_span_ref, 8, 5, bf)}.items():
        mp = 3
        prefill = "prefill" in row
        pools = _e4m3_pools(torch, gen, dev, 2, b * mp, kvn, ps, d)
        shape = (b, s) if s else (b,)
        qkv = torch.randn((*shape, 3 * kvn * d), generator=gen, device=dev,
                          dtype=dtype) * 300
        nk = qkv[..., kvn * d:2 * kvn * d].reshape(*shape, kvn, d)
        nv = qkv[..., 2 * kvn * d:].reshape(*shape, kvn, d)      # strided
        tables = _tables(torch, dev, b, mp)
        pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
        if "span" in row:
            pos[0] = ps - 2                     # a span across a page
        args = (nk, nv, tables) + (() if prefill else (pos,)) + (layer,)
        a, r = [p.clone() for p in pools], [p.clone() for p in pools]
        kern(*a, *args)
        plain(*r, *args)
        torch.cuda.synchronize()
        require(a[0].dtype == torch.float8_e4m3fn,
                f"{row} {tag}: not e4m3 pools")
        err = sum(_codes_err(torch, x[:, :-1], y[:, :-1])
                  for x, y in zip(a, r))
        nan = int((a[0].view(torch.uint8) & 0x7F == 0x7F).sum())
        print(f"[kernels] {row} {tag} (B={b} S={s} kvN={kvn} D={d} "
              f"{dname(torch, dtype)}): {err} bytes apart (tol 0, "
              f"byte-equal; trash page excluded); {nan} NaN codes (rows "
              f"past 464)", flush=True)
        require(err == 0 and nan > 0, f"{row} {tag} disagrees: {err}, NaN "
                f"codes {nan}")
        if row in results:
            continue
        p1 = pools[0].shape[1]
        if prefill:
            npg = -(-s // ps)
            written = 2 * b * npg * ps * kvn * d
            idx = tables[:, :npg].long()
            idx = torch.where(idx >= 0, idx, p1 - 1).reshape(-1)
            ck, cv = (x.reshape(b, npg, ps, kvn, d).transpose(2, 3).reshape(
                b * npg, kvn, ps, d) for x in (nk, nv))

            def library(a=a, ck=ck, cv=cv, idx=idx):
                for pool, x in ((a[0], ck), (a[1], cv)):
                    pool.view(torch.uint8)[layer].index_copy_(
                        0, idx, _cast_lib(torch, x))
        else:
            t = max(s, 1)
            written = 2 * b * t * kvn * d
            page, slot = pa.span_slots(tables, pos, t, p1, ps)
            heads = torch.arange(kvn, device=dev)
            ix = (page[:, :, None], heads[None, None], slot[:, :, None])
            xk, xv = (x.reshape(b, t, kvn, d) for x in (nk, nv))

            def library(a=a, xk=xk, xv=xv, ix=ix):
                for pool, x in ((a[0], xk), (a[1], xv)):
                    pool.view(torch.uint8)[layer].index_put_(
                        ix, _cast_lib(torch, x))
        rows_b = 2 * b * max(s, 1) * kvn * d * nk.element_size()
        bms, by = bound_ms(rows_b + written + tables.numel() * 4 + b * 4,
                           0.0, dname(torch, dtype))
        res = dict(max_abs_err=float(err),
                   ms=time_ms(torch, lambda: kern(*a, *args)),
                   plain_ms=time_ms(torch, lambda: plain(*r, *args)),
                   library_ms=time_ms(torch, library), bound_ms=bms,
                   bound_by=by, library=LIBRARY[row])
        results[row] = res
        extra.append((row, tag, res))

    # 6e/256 and 6ek/256
    for tag, (b, h, n, kvh, xdt, kv_layer, row) in {
            "gemma-2b": (8, 2048, 8, 1, bf, None,
                         "fused_qkv_append_fp8kv_d256"),
            "gemma-2b f32 (fma)": (8, 2048, 8, 1, f32, None, None),
            "gemma-2-2b kv_layer": (8, 2304, 8, kvn, bf, 0,
                                    "fused_qkv_append_fp8kv_kv_layer_d256"),
            "gemma-2-2b kv_layer m3 f32": (3, 2304, 8, kvn, f32, 0,
                                           None)}.items():
        mp = 6
        kli = layer if kv_layer is None else kv_layer
        nq = (n + 2 * kvh) * d
        wq, ws = _qweight(torch, gen, dev, (2, h, nq), 1)
        ws = ws * 300                           # k/v past 464 too
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(xdt)
        x = torch.randn((b, h), generator=gen, device=dev).to(xdt)
        pk, pv = _e4m3_pools(torch, gen, dev, 2, b * mp, kvh, ps, d)
        tables = _tables(torch, dev, b, mp, dead_last=False)
        pos = (128 + 4 * torch.arange(b, device=dev)).to(torch.int32)
        tables[-1, int(pos[-1]) // ps] = -1      # the trash page
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        kw = dict(n_heads=n, kv_heads=kvh, tables=tables, kv_layer=kv_layer)
        a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())

        def call(a=a, x=x, nw=nw, wq=wq, ws=ws, sin=sin, cos=cos, kw=kw,
                 pos=pos):
            return fused_qkv_append(x, nw, wq, ws, sin, cos, *a, layer, pos,
                                    **kw)[0]

        qa = call()
        qr = fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, layer, pos,
                                  **kw)[0]
        torch.cuda.synchronize()
        page = tables.long()[torch.arange(b, device=dev), pos.long() // ps]
        page = torch.where(page >= 0, page, pk.shape[1] - 1)
        written = torch.zeros(pk.shape, dtype=torch.bool, device=dev)
        written[kli, page, :, pos.long() % ps] = True
        err = max_err(qa, qr)
        lim_q = (F32_REL * float(qr.abs().max()) if xdt == f32
                 else TOL["bfloat16"] * float(qr.float().std()))
        steps = max(int((_e4m3_ordinal(torch, ta[written])
                         - _e4m3_ordinal(torch, tr[written])).abs().max())
                    for ta, tr in zip(a, r))
        apart = sum(_codes_err(torch, ta[written], tr[written])
                    for ta, tr in zip(a, r))
        nan = sum(int((tr[written].view(torch.uint8) & 0x7F == 0x7F).sum())
                  for tr in r)
        untouched = all(_codes_err(torch, ta[~written], tr[~written]) == 0
                        for ta, tr in zip(a, r))
        print(f"[kernels] fused_qkv_append_fp8kv/256 {tag} (B={b} H={h} "
              f"N={n} kvN={kvh} kv_layer={kv_layer}): q max|err| {err:.3e} "
              f"(tol {lim_q:.3e}); k/v codes {apart} of "
              f"{2 * int(written.sum())} apart, at most {steps} step (tol "
              f"1); {nan} NaN codes (k/v past 464); other entries equal: "
              f"{untouched}", flush=True)
        require(pk.dtype == torch.float8_e4m3fn
                and bool(torch.isfinite(qa).all()) and err <= lim_q
                and steps <= 1 and untouched and nan > 0,
                f"fused_qkv_append_fp8kv/256 {tag} disagrees: {err}, "
                f"{steps}, {untouched}, {nan}")
        if row is None:
            continue
        nbytes = _qkv_nbytes(h, nq, b, n, kvh, d, x.element_size(),
                             nw.element_size(), d,
                             tables.numel() * 4 + b * 4)
        bms, by = bound_ms(nbytes, 2.0 * b * h * nq, dname(torch, xdt))
        qt, st = _int8pack(torch, wq[layer], ws[layer], xdt)
        res = dict(
            max_abs_err=max(err, float(steps)), ms=time_ms(torch, call),
            plain_ms=time_ms(torch, lambda: fused_qkv_append_ref(
                x, nw, wq, ws, sin, cos, *r, layer, pos, **kw)),
            library_ms=time_ms(torch, lambda: torch._weight_int8pack_mm(
                x, qt, st)),
            bound_ms=bms, bound_by=by, library=LIBRARY[row])
        results[row] = res
        extra.append((row, tag, res))


def _e4m3_arena(torch, gen, dev, layers, rows, kvn, smax, d):
    """An e4m3 dense arena [L, rows, kvN, Smax, D] as the Generator fills
    it: N(0, 1) K/V rows cast by the plain to_e4m3."""
    from simplellminference_tpu_torch.ops.ref_ops import to_e4m3
    shape = (layers, rows, kvn, smax, d)
    return tuple(to_e4m3(torch.randn(shape, generator=gen, device=dev))
                 for _ in range(2))


def _stale_nan(torch, arenas, layer, lens, window):
    """Code 0x7f (NaN in e4m3fn) in every slot of ``layer`` a row must
    not read: past kv_len, and below the band with a window."""
    smax = arenas[0].shape[3]
    for a in arenas:
        u = a.view(torch.uint8)
        for r, ln in enumerate(lens):
            u[layer, r, :, max(0, min(ln, smax)):] = 0x7F
            if window:
                u[layer, r, :, :max(0, min(ln - window, smax))] = 0x7F


def check_dense_fp8kv(torch, dev, results, extra):
    """FP8 (e4m3) KV on the dense arena: 12e (kv_append into an e4m3
    arena) byte-equal to its plain version over the whole arena (the
    dense paths' decode and prefill calls at Llama-2-7B, Gemma-2-2B's D
    256 and gpt-oss-20b's D 64; f32 rows at and past Smax, dropped; rows
    past 464: NaN codes); the 13e-forms (13e, 13ew, 13ec, 13ewc, 13es,
    13ews and 13e/256) by the rounding rule over arenas whose slots past
    kv_len and below the band hold code 0x7f (NaN), which no form may
    read: `dense_fp8kv`'s decode (Llama-2-7B, the row), Gemma-2-2B's
    (`gemma2_dense_fp8kv`: 4 rows over an arena of 4608 slots at kv_len
    4224-4288, uncapped, capped and windowed), Mistral-7B's window 4096,
    gpt-oss-20b's sinks (`gpt_oss_dense_fp8kv`: 8 rows over 256 slots;
    kv_len 4096 with a sink above every score: a split walk), edges
    (kv_len 0, 1, Smax and past it, the band's edges, past the cap), f32;
    6de (the dense fused qkv into an e4m3 arena) at Llama-2-7B (8 bf16
    rows: 6m, the row) and Gemma-2-2B (6de/256, 4 rows), an f32 case on
    the FMA kernel with a slot at Smax (dropped), its codes at most one
    e4m3 step from the plain version's (6e's rule: sums in another order
    may cross a rounding midpoint; the number apart printed) or, past one
    step, the two values within the dense bf16 form's k/v rule (2e-2 of
    the written values' standard deviation; f32 rows 1e-5 of their
    largest): the kernel's rmsnorm may round an element of the normalized
    row to the next bf16, which moves every output of the row by the same
    absolute amount, many e4m3 steps of a value near zero; every other
    byte equal. Each timed case beside
    its plain version, its bytes bound and the library call (PyTorch's
    e4m3 cast + index_copy_; scaled_dot_product_attention over the arena
    cast to q's dtype in the call, uncapped and without sinks;
    torch._weight_int8pack_mm of the qkv product alone)."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.ops import kv_append as ka
    from simplellminference_tpu_torch.ops import ref_ops
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    from simplellminference_tpu_torch.ops.qkv_fused import (
        fused_qkv_append, fused_qkv_append_ref)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2525)
    bf, f32 = torch.bfloat16, torch.float32
    layer = 1
    g2 = (GEMMA2["n"], GEMMA2["kvn"], GEMMA2["d"])
    oss = (GPT_OSS["n"], GPT_OSS["kvn"], GPT_OSS["d"])

    # 12e: tag -> (B, arena rows, S, kvN, D, Smax, row dtype, offsets,
    # kernels-line row if timed)
    cases = {
        "llama2-7b decode": (8, 8, 1, 32, 128, 256, bf,
                             [128 + 4 * i for i in range(8)],
                             "kv_append_fp8kv"),
        "llama2-7b prefill": (8, 8, 128, 32, 128, 256, bf, [0] * 8, None),
        "gemma-2-2b prefill": (4, 4, 4608, 4, 256, 4608, bf, [0] * 4,
                               "kv_append_fp8kv_d256"),
        "gemma-2-2b decode": (4, 4, 1, 4, 256, 4608, bf,
                              [4224, 4245, 4266, 4607], None),
        "gpt-oss-20b decode": (8, 8, 1, 8, 64, 256, bf,
                               [160 + 8 * i for i in range(8)], None),
        "gqa f32 at/past Smax": (6, 7, 1, 4, 64, 384, f32,
                                 [0, 383, 384, 390, -1, 100], None),
        "f32 S=8 past Smax": (3, 5, 8, 4, 64, 384, f32, [3, 380, 500], None),
    }
    for tag, (b, rows, s, kvn, d, smax, dtype, offs, row) in cases.items():
        ck, cv = _e4m3_arena(torch, gen, dev, 2, rows, kvn, smax, d)
        qkv = torch.randn((b, s, 3 * kvn * d), generator=gen, device=dev,
                          dtype=dtype) * 300
        nk = qkv[..., kvn * d:2 * kvn * d].reshape(b, s, kvn, d)
        nv = qkv[..., 2 * kvn * d:].reshape(b, s, kvn, d)   # strided views
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        a, r = (ck.clone(), cv.clone()), (ck.clone(), cv.clone())
        ka.kv_append(*a, nk, nv, layer, off)
        ka.kv_append_ref(*r, nk, nv, layer, off)
        torch.cuda.synchronize()
        err = sum(_codes_err(torch, x, y) for x, y in zip(a, r))
        nan = int((a[0].view(torch.uint8) & 0x7F == 0x7F).sum())
        print(f"[kernels] kv_append_fp8kv {tag} (B={b} into {rows} rows, "
              f"S={s}, kvN={kvn}, D={d}, Smax={smax}, "
              f"{dname(torch, dtype)}): {err} bytes apart (tol 0, "
              f"byte-equal; whole arena); {nan} NaN codes (rows past 464)",
              flush=True)
        require(a[0].dtype == torch.float8_e4m3fn and err == 0 and nan > 0,
                f"kv_append_fp8kv {tag} disagrees: {err}, NaN codes {nan}")
        if row is None:
            continue
        es = nk.element_size()
        nbytes = 2 * b * s * kvn * d * (es + 1) + b * 4
        bms, by = bound_ms(nbytes, 0.0, dname(torch, dtype))
        slot = off.long()[:, None, None] + torch.arange(s, device=dev)
        idx = ((torch.arange(b, device=dev)[:, None, None] * kvn
                + torch.arange(kvn, device=dev)[None, :, None]) * smax
               + slot).reshape(-1)
        sk = nk.permute(0, 2, 1, 3).reshape(-1, d)
        sv = nv.permute(0, 2, 1, 3).reshape(-1, d)
        fk, fv = (x.view(torch.uint8)[layer].view(-1, d) for x in a)

        def library(fk=fk, fv=fv, idx=idx, sk=sk, sv=sv):
            fk.index_copy_(0, idx, _cast_lib(torch, sk))
            fv.index_copy_(0, idx, _cast_lib(torch, sv))

        res = dict(
            max_abs_err=float(err),
            ms=time_ms(torch, lambda: ka.kv_append(*a, nk, nv, layer, off)),
            plain_ms=time_ms(torch, lambda: ka.kv_append_ref(
                *r, nk, nv, layer, off)),
            library_ms=time_ms(torch, library), bound_ms=bms, bound_by=by,
            library=LIBRARY[row])
        results[row] = res
        extra.append((row, tag, res))
        del ck, cv, a, r

    # the 13e-forms: tag -> (heads, Smax, window, cap, sinks (None, "draw"
    # or "above"), q scale, dtype, lens, kernels-line row if timed)
    cap = GEMMA2["cap"]
    g2_lens = [4224, 4245, 4266, 4288]
    oss_lens = [160 + 8 * i for i in range(8)]
    oss_edges = [0, 1, 127, 128, 129, 255, 256, 3]
    cases = {
        "llama2-7b": ((32, 32, 128), 256, None, None, None, 1.0, bf,
                      [145 + 2 * i for i in range(8)], "flash_decode_fp8kv"),
        "llama2-7b edge lens": ((32, 32, 128), 256, None, None, None, 1.0,
                                bf, [0, 1, 161, 256, 300, 17, 128, 255],
                                None),
        "llama2-7b f32 edge lens": ((32, 32, 128), 256, None, None, None,
                                    1.0, f32, [0, 1, 161, 256, 300], None),
        "gemma-2-2b uncapped": (g2, 4608, None, None, None, 1.0, bf,
                                g2_lens, "flash_decode_fp8kv_d256"),
        "gemma-2-2b": (g2, 4608, None, cap, None, 1.0, bf, g2_lens,
                       "flash_decode_fp8kv_cap_d256"),
        "gemma-2-2b window": (g2, 4608, WINDOW, cap, None, 1.0, bf, g2_lens,
                              "flash_decode_fp8kv_window_cap_d256"),
        "gemma-2-2b window edges past the cap": (
            g2, 4608, WINDOW, cap, None, 60.0, bf,
            [0, 1, 100, 4095, 4096, 4097, 4607, 4608, 4700], None),
        "gemma-2-2b f32 past the cap": (g2, 4608, None, cap, None, 60.0,
                                        f32, [0, 7, 4097, 4700], None),
        "mistral-7b window": ((32, 8, 128), 4608, WINDOW, None, None, 1.0,
                              bf, [4224 + 40 * i for i in range(8)],
                              "flash_decode_fp8kv_window"),
        "gpt-oss-20b": (oss, OSS_DENSE_SMAX, None, None, "draw", 1.0, bf,
                        oss_lens, "flash_decode_fp8kv_sinks"),
        "gpt-oss-20b window": (oss, OSS_DENSE_SMAX, GPT_OSS["window"], None,
                               "draw", 1.0, bf, oss_lens,
                               "flash_decode_fp8kv_window_sinks"),
        "kv_len 4096 sink above": (oss, 4224, None, None, "above", 1.0, bf,
                                   [4096] * 8, None),
        "window edges sink above": (oss, OSS_DENSE_SMAX, GPT_OSS["window"],
                                    None, "above", 1.0, bf, oss_edges, None),
        "f32 window sinks": (oss, 4224, GPT_OSS["window"], None, "draw", 1.0,
                             f32, [0, 7, 129, 4100], None),
    }
    for tag, ((n, kvn, d), smax, w, cp, sk_kind, qx, dtype, lens,
              row) in cases.items():
        b = len(lens)
        ck, cv = _e4m3_arena(torch, gen, dev, 2, b + 1, kvn, smax, d)
        clean = (ck.clone(), cv.clone())
        _stale_nan(torch, (ck, cv), layer, lens, w)
        q = torch.randn((b, n, d), generator=gen, device=dev,
                        dtype=dtype) * qx
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        sinks = (None if sk_kind is None
                 else _sink_draw(torch, gen, dev, n, sk_kind == "above"))

        def run(q=q, ck=ck, cv=cv, kv=kv, w=w, cp=cp, sinks=sinks):
            return fd.flash_decode(q, ck, cv, kv, layer=layer, window=w,
                                   logit_cap=cp, sinks=sinks)

        def plain(q=q, ck=ck, cv=cv, kv=kv, w=w, cp=cp, sinks=sinks):
            return fd.flash_decode_ref(q, ck, cv, kv, layer=layer,
                                       window=w, logit_cap=cp, sinks=sinks)

        got, want = run(), plain()
        again = fd.flash_decode(q, *clean, kv, layer=layer, window=w,
                                logit_cap=cp, sinks=sinks)
        torch.cuda.synchronize()
        splits = pd.decode_splits(b, kvn, min(smax, w) if w else smax,
                                  pd.row_blocks(n // kvn))
        label = (f"{tag} (B={b} N={n} kvN={kvn} D={d} Smax={smax} "
                 f"window={w} cap {cp} sinks {sk_kind}, {splits} splits; "
                 f"NaN codes past kv_len and below the band)")
        dead = [i for i in range(b) if lens[i] <= 0
                or (w and lens[i] - w >= smax)]
        if sinks is None:
            err = _attn_check(torch, "flash_decode_fp8kv", label, got, want,
                              dead)
        else:
            err = _sink_rule(
                torch, "flash_decode_fp8kv", label, got, want,
                sk_kind == "above",
                _top_score(torch, q[:, None],
                           clean[0][layer, :b].float().transpose(1, 2),
                           d ** -0.5), dead)
            require(sk_kind != "above" or w or splits > 1,
                    f"flash_decode_fp8kv {tag}: one split only")
        require(torch.equal(got, again), f"flash_decode_fp8kv {tag}: the "
                f"stale NaN slots moved the output")
        if row is None:
            del ck, cv, clean
            continue
        span = [min(ln, smax) - (max(0, ln - w) if w else 0) for ln in lens]
        es = q.element_size()
        bms, by = bound_ms(2 * b * n * d * es + 2 * sum(span) * kvn * d
                           + b * 4 + (4 * n if sinks is not None else 0),
                           4.0 * n * d * sum(span), "bfloat16")
        top = max(lens)
        key_pos = torch.arange(top, device=dev)[None, None, None, :]
        mask = key_pos < kv.long()[:, None, None, None]
        if w:
            mask = mask & (key_pos >= kv.long()[:, None, None, None] - w)
        k8, v8 = ck[layer, :b, :, :top], cv[layer, :b, :, :top]

        def library(q=q, k8=k8, v8=v8, mask=mask, n=n):
            # the arena's codes cast to q's dtype in the call (uncapped,
            # no sinks: the library has neither)
            return F.scaled_dot_product_attention(
                q[:, :, None], _gqa(torch, k8.to(q.dtype), n),
                _gqa(torch, v8.to(q.dtype), n), attn_mask=mask)

        results[row] = dict(
            max_abs_err=err, ms=time_ms(torch, run),
            plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, library), bound_ms=bms, bound_by=by,
            library=LIBRARY[row])
        del ck, cv, clean, k8, v8

    # 6de: tag -> (B, arena rows, H, (N, kvN, D), Smax, x dtype, offsets,
    # kernels-line row if timed)
    cases = {
        "llama2-7b": (8, 8, 4096, (32, 32, 128), 256, bf,
                      [128 + 4 * i for i in range(8)],
                      "fused_qkv_append_fp8kv_dense"),
        "gemma-2-2b": (4, 4, GEMMA2["h"], g2, 4608, bf,
                       [4224, 4245, 4266, 4607],
                       "fused_qkv_append_fp8kv_dense_d256"),
        "draft B+1 f32 (fma; a slot at Smax)": (
            9, 9, 2048, (32, 4, 64), 384, f32,
            [0, 383, 384, 10, 200, 1, 2, 3, 0], None),
        "gemma-2-2b rows < arena f32 (fma)": (3, 4, GEMMA2["h"], g2, 4608,
                                              f32, [7, 0, 4607], None),
    }
    for tag, (b, rows, h, (n, kvn, d), smax, xdt, offs,
              row) in cases.items():
        nq = (n + 2 * kvn) * d
        wq, ws = _qweight(torch, gen, dev, (2, h, nq), 1)
        ws = ws * 300                           # k/v past 464 too
        nw = (1.0 + 0.1 * torch.randn((2, h), generator=gen, device=dev)
              ).to(xdt)
        x = torch.randn((b, h), generator=gen, device=dev).to(xdt)
        ck, cv = _e4m3_arena(torch, gen, dev, 2, rows, kvn, smax, d)
        pos = torch.tensor(offs, dtype=torch.int32, device=dev)
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        kw = dict(n_heads=n, kv_heads=kvn)
        a, r = (ck.clone(), cv.clone()), (ck.clone(), cv.clone())

        def call(a=a, x=x, nw=nw, wq=wq, ws=ws, sin=sin, cos=cos, kw=kw,
                 pos=pos):
            return fused_qkv_append(x, nw, wq, ws, sin, cos, *a, layer, pos,
                                    **kw)[0]

        def plain(r=r, x=x, nw=nw, wq=wq, ws=ws, sin=sin, cos=cos, kw=kw,
                  pos=pos):
            return fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, layer,
                                        pos, **kw)[0]

        qa, qr = call(), plain()
        torch.cuda.synchronize()
        written = torch.zeros(ck.shape, dtype=torch.bool, device=dev)
        for i, o in enumerate(offs):
            if 0 <= o < smax:
                written[layer, i, :, o] = True
        err = max_err(qa, qr)
        lim_q = (F32_REL * float(qr.abs().max()) if xdt == f32
                 else TOL["bfloat16"] * float(qr.float().std()))
        steps, far, apart = 0, [], 0
        for ta, tr in zip(a, r):
            ga, gr = ta[written], tr[written]
            st = (_e4m3_ordinal(torch, ga) - _e4m3_ordinal(torch, gr)).abs()
            steps = max(steps, int(st.max()))
            apart += _codes_err(torch, ga, gr)
            # past one step: the values, held to the dense bf16 form's k/v
            # rule (check_fused_qkv_dense) beside the plain version's
            fin = gr.float()[torch.isfinite(gr.float())]
            lim_kv = (F32_REL * float(fin.abs().max()) if xdt == f32
                      else TOL["bfloat16"] * float(fin.std()))
            for i in torch.nonzero(st > 1).flatten().tolist():
                far.append((float(gr[i].float()), float(ga[i].float()),
                            lim_kv))
        far_ok = all(abs(x - y) <= lim for x, y, lim in far)
        nan = sum(int((tr[written].view(torch.uint8) & 0x7F == 0x7F).sum())
                  for tr in r)
        untouched = all(_codes_err(torch, ta[~written], tr[~written]) == 0
                        for ta, tr in zip(a, r))
        print(f"[kernels] fused_qkv_append_fp8kv dense {tag} (B={b} into "
              f"{rows} rows, H={h} N={n} kvN={kvn} D={d} Smax={smax}): q "
              f"max|err| {err:.3e} (tol {lim_q:.3e}); k/v codes {apart} of "
              f"{2 * int(written.sum())} apart, at most {steps} step (tol "
              f"1, 6e's rule; past it (plain value, kernel value, tol of "
              f"the bf16 form's k/v rule): {far[:6]}); {nan} NaN codes "
              f"(k/v past 464); other entries equal: {untouched}",
              flush=True)
        require(bool(torch.isfinite(qa).all()) and err <= lim_q
                and far_ok and untouched and nan > 0,
                f"fused_qkv_append_fp8kv dense {tag} disagrees: {err}, "
                f"{steps} {far[:6]}, {untouched}, {nan}")
        if row is None:
            del ck, cv, a, r
            continue
        nbytes = _qkv_nbytes(h, nq, b, n, kvn, d, x.element_size(),
                             nw.element_size(), d, b * 4)
        bms, by = bound_ms(nbytes, 2.0 * b * h * nq, dname(torch, xdt))
        qt, st = _int8pack(torch, wq[layer], ws[layer], xdt)
        res = dict(
            max_abs_err=max(err, float(steps)), ms=time_ms(torch, call),
            plain_ms=time_ms(torch, plain),
            library_ms=time_ms(torch, lambda: torch._weight_int8pack_mm(
                x, qt, st)),
            bound_ms=bms, bound_by=by, library=LIBRARY[row])
        results[row] = res
        extra.append((row, tag, res))
        del ck, cv, a, r
    print(f"[kernels] FP8 KV on the dense arena: the checks took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

# benchmarks/bench_mla.py:22-29's HF dict (DeepSeek-V2-Lite's attention
# geometry, dense FFNs, 16 layers), written here as the `mla` paths and
# phase 3's and 5's MLA checks serve it; the benchmark is not imported
MLA_HF = dict(
    model_type="deepseek_v2", vocab_size=8192, hidden_size=2048,
    intermediate_size=5632, num_hidden_layers=16, num_attention_heads=16,
    num_key_value_heads=16, max_position_embeddings=4096,
    rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False,
    n_routed_experts=None, q_lora_rank=None, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    first_k_dense_replace=16, attention_bias=False)
# the absorbed geometry: 16 q heads over one latent row of 640 lanes
MLA = dict(n=16, kvn=1, d=640)
FP32_CORE_OPS = 67e12   # f32 outside the tensor cores (the FMA bodies)


def mla_config(num_layers: int = 16, dtype: str = "bfloat16",
               absorbed: bool = True):
    """bench_mla.py's ModelConfig (``run()``: from_hf_dict of
    :data:`MLA_HF`) through the port's ``from_hf_dict``, at depth
    ``num_layers`` (first_k_dense_replace stays past it: every layer's FFN
    dense), absorbed or naive."""
    from simplellminference_tpu_torch.core.config import ModelConfig
    return ModelConfig.from_hf_dict(
        dict(MLA_HF, num_hidden_layers=num_layers), dtype=dtype,
        mla_absorbed=absorbed)


def check_mla(torch, dev, results, extra):
    """Absorbed MLA's shared-KV forms against their plain versions at
    DeepSeek-V2-Lite's absorbed geometry (16 q heads over one latent row of
    640 lanes, pages of 128), the `mla` path's shapes: 1l and 2l
    byte-equal over the whole pool (the V pool absent; the pages no row
    goes to untouched: byte-equal to the pool before the call), 1l at the
    decode step (8 rows at ~1,152) and 2l at the 512-row chunks at offsets
    0 and 512, a ragged f32 chunk; 4l/640 by the rounding rule at the path's
    decode (8 rows at kv_len 1,090-1,160) and at kv_len 4096, f32, edge
    lens (0, 1, a page's edges) and an unmapped page, and 4l at D 128; 8l
    at offsets 0 and 512 (chunk 512, bf16) by the prefill rule, f32 with
    ragged offsets and a padding row, and at D 128; 3l/640 at 8 x 128 rows
    (bf16), f32, and ragged S. Each timed form beside its plain version,
    its bound (bytes and the bf16 peak; the FP32-core time of the FMA
    bodies' operations printed beside it) and the library call:
    scaled_dot_product_attention over the latent rows gathered, K as V,
    enable_gqa (causal or masked), index_put_ / index_copy_ for the
    writes."""
    import torch.nn.functional as F

    from simplellminference_tpu_torch.memory.paged_kv import gather_dense
    from simplellminference_tpu_torch.ops import paged_append as pa
    from simplellminference_tpu_torch.ops.attention import flash_prefill as fp
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    from simplellminference_tpu_torch.ops.attention import paged_prefill as pp
    gen = torch.Generator(device=dev).manual_seed(2626)
    bf, f32 = torch.bfloat16, torch.float32
    n, kvn, d = MLA["n"], MLA["kvn"], MLA["d"]
    ps, layer = 128, 1
    scale = 192 ** -0.5   # (nope + rope)^-0.5, query_pre_attn_scalar

    def pool_of(pages, dt, dd=d):
        return torch.randn((2, pages + 1, kvn, ps, dd), generator=gen,
                           device=dev, dtype=dt)

    def timed(row, tag, fn, plain, library, nbytes, ops, dtype, err):
        bms, by = bound_ms(nbytes, ops, dname(torch, dtype))
        res = dict(max_abs_err=err, ms=time_ms(torch, fn),
                   plain_ms=time_ms(torch, plain),
                   library_ms=time_ms(torch, library), bound_ms=bms,
                   bound_by=by, library=LIBRARY[row])
        fma_ms = ops / FP32_CORE_OPS * 1e3
        print(f"[kernels] {row} {tag}: {res['ms']:.6g} ms, bound "
              f"{bms:.6g} ms by {by} ({nbytes / 1e6:.3f} MB, "
              f"{ops / 1e6:.1f} MFLOP; the operations on the FP32 cores "
              f"{fma_ms:.6g} ms)", flush=True)
        results.setdefault(row, res)
        extra.append((row, tag, res))

    # 1l: one latent row per sequence; tag -> (B, mp, positions, dtype)
    for tag, (b, mp, pos, dtype) in {
            "mla decode": (8, 15, [1090 + 10 * i for i in range(8)], bf),
            "f32 edges": (6, 3, [0, 127, 128, 383, 384, -1], f32)}.items():
        pool = pool_of(b * mp, dtype)
        tables = _tables(torch, dev, b, mp, dead_last=False)
        tables[1, 1] = -1                       # an unmapped page: trash
        row = torch.randn((b, 3, kvn, d), generator=gen, device=dev,
                          dtype=dtype)[:, 1]    # strided, like the model's
        p_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        a, r = pool.clone(), pool.clone()
        pa.paged_append_decode_shared(a, row, tables, p_t, layer)
        pa.paged_append_decode_shared_ref(r, row, tables, p_t, layer)
        torch.cuda.synchronize()
        # the trash page excluded: rows that go there land in any order
        err = max_err(a[:, :-1], r[:, :-1])
        page = pa._decode_slots(tables, p_t, pool.shape[1], ps)[0]
        keep = torch.ones(pool.shape[1], dtype=torch.bool, device=dev)
        keep[page] = False
        untouched = bool(torch.equal(a[:, keep], pool[:, keep])
                         and torch.equal(a[0], pool[0]))
        print(f"[kernels] paged_append_decode_shared {tag} (B={b}, D={d}, "
              f"{dname(torch, dtype)}): max|err| {err} (tol 0, the pool but "
              f"its trash page, no V pool); other pages and layers "
              f"untouched: {untouched}", flush=True)
        require(err == 0.0 and untouched,
                f"paged_append_decode_shared {tag}: {err}, {untouched}")
        if tag != "mla decode":
            continue
        slot = p_t.long() % ps
        heads = torch.arange(kvn, device=dev)

        def library(a=a, page=page, slot=slot, row=row, heads=heads):
            a[layer].index_put_((page[:, None], heads[None], slot[:, None]),
                                row)

        es = pool.element_size()
        timed("paged_append_decode_shared", tag,
              lambda: pa.paged_append_decode_shared(a, row, tables, p_t,
                                                    layer),
              lambda: pa.paged_append_decode_shared_ref(r, row, tables, p_t,
                                                        layer),
              library, 2 * b * kvn * d * es + tables.numel() * 4 + b * 4,
              0.0, dtype, err)
        del pool, a, r

    # 2l: a chunk's latent rows at its page offset; tag -> (B, S, page
    # offsets, mp, dtype)
    for tag, (b, s, offs, mp, dtype) in {
            "mla chunk at 0": (1, 512, [0], 15, bf),
            "mla chunk at 512": (1, 512, [4], 15, bf),
            "f32 ragged": (3, 300, [0, 1, 2], 6, f32)}.items():
        pool = pool_of(b * mp, dtype)
        tables = _tables(torch, dev, b, mp, dead_last=False)
        npg = -(-s // ps)
        cols = (torch.tensor(offs, device=dev)[:, None]
                + torch.arange(npg, device=dev)[None])
        tcols = tables.long().gather(1, cols).to(torch.int32)
        x = torch.randn((b, s, 2, kvn, d), generator=gen, device=dev,
                        dtype=dtype)[:, :, 0]   # strided
        a, r = pool.clone(), pool.clone()
        pa.paged_append_prefill_shared(a, x, tcols, layer)
        pa.paged_append_prefill_shared_ref(r, x, tcols, layer)
        torch.cuda.synchronize()
        err = max_err(a, r)
        keep = torch.ones(pool.shape[1], dtype=torch.bool, device=dev)
        keep[tcols.long().reshape(-1)] = False
        untouched = bool(torch.equal(a[:, keep], pool[:, keep])
                         and torch.equal(a[0], pool[0]))
        print(f"[kernels] paged_append_prefill_shared {tag} (B={b}, S={s}, "
              f"D={d}, {dname(torch, dtype)}, "
              f"{pa.prefill_parts(b * npg * kvn, ps)} blocks a page): "
              f"max|err| {err} (tol 0, whole pool, no V pool); other pages "
              f"and layers untouched: {untouched}", flush=True)
        require(err == 0.0 and untouched,
                f"paged_append_prefill_shared {tag}: {err}, {untouched}")
        if tag != "mla chunk at 512":
            continue
        idx = tcols.long().reshape(-1)
        chunks = pa._page_chunks(x, npg, ps)

        def library(a=a, idx=idx, chunks=chunks):
            a[layer].index_copy_(0, idx, chunks)

        es = pool.element_size()
        timed("paged_append_prefill_shared", tag,
              lambda: pa.paged_append_prefill_shared(a, x, tcols, layer),
              lambda: pa.paged_append_prefill_shared_ref(r, x, tcols, layer),
              library, b * s * kvn * d * es + b * npg * ps * kvn * d * es
              + tcols.numel() * 4, 0.0, dtype, err)
        del pool, a, r

    # 4l: tag -> (n, d, dtype, lens, mp, unmapped page)
    path_lens = [1090 + 10 * i for i in range(8)]
    cases = {
        "mla decode": (n, d, bf, path_lens, 15, False),
        "mla kv_len 4096": (n, d, bf, [4096] * 8, 33, False),
        "mla f32": (n, d, f32, path_lens, 15, False),
        "mla edge lens": (n, d, bf, [0, 1, 127, 128, 129, 1919, 1920, 64],
                          15, True),
        "mla f32 edge lens": (n, d, f32, [0, 1, 128, 300], 3, True),
        "d 128": (n, 128, bf, path_lens, 15, False),
        "d 128 f32": (4, 128, f32, [0, 5, 129, 250], 2, True),
    }
    for tag, (nn, dd, dtype, lens, mp, unmapped) in cases.items():
        b = len(lens)
        pool = pool_of(b * mp, dtype, dd)
        q = torch.randn((b, nn, dd), generator=gen, device=dev, dtype=dtype)
        tables = _tables(torch, dev, b, mp, dead_last=False)
        if unmapped:
            tables[2, 0] = -1
        kv_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = pd.paged_flash_decode(q, pool, None, tables, kv_t, layer,
                                    sm_scale=scale)
        want = pd.paged_flash_decode_ref(q, pool, None, tables, kv_t, layer,
                                         sm_scale=scale)
        torch.cuda.synchronize()
        zero = [i for i in range(b) if lens[i] == 0]
        err = _attn_check(torch, "paged_flash_decode_shared", tag, got, want,
                          zero)
        if tag not in ("mla decode", "mla kv_len 4096"):
            continue
        ck, _ = gather_dense(pool[layer], None, tables)
        mask = (torch.arange(ck.shape[2], device=dev)[None, None, None, :]
                < kv_t.long()[:, None, None, None])
        q4 = q[:, :, None]
        es = q.element_size()
        kvb, live = _decode_bytes(torch, tables, kv_t, ps, kvn * dd * es)
        timed("paged_flash_decode_shared", tag,
              lambda: pd.paged_flash_decode_shared(q, pool, tables, kv_t,
                                                   layer, scale),
              lambda: pd.paged_flash_decode_ref(q, pool, None, tables, kv_t,
                                                layer, sm_scale=scale),
              lambda: F.scaled_dot_product_attention(
                  q4, ck, ck, attn_mask=mask, scale=scale, enable_gqa=True),
              2 * b * nn * dd * es + kvb + tables.numel() * 4 + b * 4,
              4.0 * nn * dd * live, dtype, err)
        del pool, ck

    # 8l: tag -> (sq, n, d, offsets, kv_lens, mp, dtype, padding row)
    cases = {
        "mla chunk at 0": (512, n, d, [0], [512], 15, bf, False),
        "mla chunk at 512": (512, n, d, [512], [1024], 15, bf, False),
        "mla f32 ragged": (100, n, d, [0, 128, 256, 0], [100, 200, 356, 1],
                           4, f32, True),
        "d 128": (512, n, 128, [512], [1024], 15, bf, False),
        "d 128 f32": (70, 4, 128, [0, 128], [70, 150], 2, f32, False),
    }
    for tag, (sq, nn, dd, offs, lens, mp, dtype, pad) in cases.items():
        b = len(offs)
        pool = pool_of(b * mp, dtype, dd)
        tables = _tables(torch, dev, b, mp, dead_last=pad)
        q = torch.randn((b, sq, nn, dd), generator=gen, device=dev,
                        dtype=dtype)
        off_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        kv_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = pp.paged_flash_prefill(q, pool, None, tables, kv_t, off_t,
                                     layer, sm_scale=scale)
        want = pp.paged_flash_prefill_shared_ref(q, pool, tables, kv_t,
                                                 off_t, layer, scale)
        torch.cuda.synchronize()
        ok, err, note = _prefill_rule(torch, got, want)
        print(f"[kernels] paged_flash_prefill_shared {tag} (B={b} Sq={sq} "
              f"N={nn} kvN={kvn} D={dd}, {dname(torch, dtype)}, splits "
              f"{pp.prefill_tiles.launch_splits(b, sq, nn, kvn, 0, mp * ps)}"
              f"): max|err| {err:.3e} ({note}); every row finite: "
              f"{bool(torch.isfinite(got).all())}", flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"paged_flash_prefill_shared {tag} disagrees: {err} ({note})")
        if not tag.startswith("mla chunk"):
            continue
        es = q.element_size()
        keys = sum(min(o + r + 1, ln) for o, ln in zip(offs, lens)
                   for r in range(sq))
        rows = sum(min(ln, o + sq) for o, ln in zip(offs, lens))
        ck, _ = gather_dense(pool[layer], None, tables)
        key_pos = torch.arange(ck.shape[2], device=dev)
        q_pos = off_t.long()[:, None] + torch.arange(sq, device=dev)[None]
        mask = ((key_pos[None, None] <= q_pos[:, :, None])
                & (key_pos[None, None] < kv_t.long()[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        timed("paged_flash_prefill_shared", tag,
              lambda: pp.paged_flash_prefill_shared(q, pool, tables, kv_t,
                                                    off_t, layer, scale),
              lambda: pp.paged_flash_prefill_shared_ref(
                  q, pool, tables, kv_t, off_t, layer, scale),
              lambda: F.scaled_dot_product_attention(
                  qt, ck, ck, attn_mask=mask, scale=scale, enable_gqa=True),
              2 * b * sq * nn * dd * es + rows * kvn * dd * es
              + tables.numel() * 4 + 2 * b * 4, 4.0 * nn * dd * keys,
              dtype, err)
        del pool, ck

    # 3l: tag -> (B, S, n, d, dtype)
    for tag, (b, s, nn, dd, dtype) in {
            "mla 8 x 128": (8, 128, n, d, bf),
            "mla f32": (2, 100, n, d, f32),
            "mla ragged 200": (2, 200, n, d, bf),
            "d 128": (4, 96, n, 128, bf)}.items():
        qkv = torch.randn((b, s, nn + kvn, dd), generator=gen, device=dev,
                          dtype=dtype)
        q, kv = qkv[:, :, :nn], qkv[:, :, nn:]   # strided views
        got = fp.flash_prefill_shared(q, kv, sm_scale=scale)
        want = fp.flash_prefill_ref(q, kv, kv, scale)
        torch.cuda.synchronize()
        ok, err, note = _prefill_rule(torch, got, want)
        print(f"[kernels] flash_prefill_shared {tag} (B={b} S={s} N={nn} "
              f"kvN={kvn} D={dd}, {dname(torch, dtype)}): max|err| "
              f"{err:.3e} ({note}); every row finite: "
              f"{bool(torch.isfinite(got).all())}", flush=True)
        require(bool(torch.isfinite(got).all()) and ok,
                f"flash_prefill_shared {tag} disagrees: {err} ({note})")
        if tag != "mla 8 x 128":
            continue
        es = q.element_size()
        qt, kt = q.transpose(1, 2), kv.transpose(1, 2)
        timed("flash_prefill_shared", tag,
              lambda: fp.flash_prefill_shared(q, kv, sm_scale=scale),
              lambda: fp.flash_prefill_ref(q, kv, kv, scale),
              lambda: F.scaled_dot_product_attention(
                  qt, kt, kt, is_causal=True, scale=scale, enable_gqa=True),
              (2 * nn + kvn) * b * s * dd * es,
              4.0 * nn * dd * b * s * (s + 1) / 2, dtype, err)


LIBRARY = {"paged_append_decode": "index_put_ x2",
           "paged_append_prefill": "index_copy_ x2",
           "flash_prefill": "scaled_dot_product_attention, causal",
           "paged_flash_decode": "scaled_dot_product_attention on gathered "
                                 "K/V",
           "quantized_matmul": "torch._weight_int8pack_mm",
           "quantized_matmul_mma": "torch.matmul on the bf16 weight",
           "quantized_matmul_rows_mma": "torch._weight_int8pack_mm",
           "fused_qkv_append": "torch._weight_int8pack_mm of the qkv "
                               "product alone",
           "fused_qkv_append_mma": "torch._weight_int8pack_mm of the qkv "
                                   "product alone",
           "fused_ffn": "torch._weight_int8pack_mm x2 (gate_up, down)",
           "fused_ffn_mma": "torch._weight_int8pack_mm x2 (gate_up, down)",
           "paged_flash_prefill": "scaled_dot_product_attention on gathered "
                                  "K/V, offset-causal mask",
           "paged_append_decode_quant": "torch quantize ops + index_put_ x4",
           "paged_append_prefill_quant": "torch quantize ops + index_copy_ "
                                         "x4",
           "paged_flash_decode_int8kv": "gather + f32 dequant + "
                                        "scaled_dot_product_attention "
                                        "(dequant included)",
           "fused_qkv_append_int8kv": "torch._weight_int8pack_mm of the qkv "
                                      "product alone",
           "paged_flash_prefill_int8kv": "gather + f32 dequant + "
                                         "scaled_dot_product_attention, "
                                         "offset-causal mask (dequant "
                                         "included)",
           "paged_append_span": "index_copy_ x2 (flattened rows)",
           "paged_flash_verify": "scaled_dot_product_attention on gathered "
                                 "K/V, verify mask",
           "paged_flash_verify_int8kv": "gather + f32 dequant + "
                                        "scaled_dot_product_attention, "
                                        "verify mask (dequant included)",
           "kv_append": "index_copy_ x2 (flattened rows)",
           "flash_decode": "scaled_dot_product_attention on the arena "
                           "slice, length mask",
           "fused_qkv_append_dense": "torch._weight_int8pack_mm of the qkv "
                                     "product alone",
           "quantized_matmul_int4": "torch._weight_int4pack_mm (group 128)",
           "quantized_matmul_int4_zs": "torch._weight_int4pack_mm (group "
                                       "128, zero points)",
           "quantized_matmul_int4_mma": "torch._weight_int4pack_mm (group "
                                        "128)",
           "quantized_matmul_int4_wgmma": "torch._weight_int4pack_mm (group "
                                          "128)",
           "quantized_matmul_w8a8": "torch quantize ops + torch._int_mm + "
                                    "scales",
           "quantized_matmul_w8a8_wgmma": "torch quantize ops + "
                                          "torch._int_mm + scales",
           "flash_prefill_window": "scaled_dot_product_attention, window "
                                   "mask",
           "paged_flash_decode_window": "scaled_dot_product_attention on "
                                        "gathered ring K/V, window mask",
           "paged_flash_decode_int8kv_window": "scaled_dot_product_attention "
                                               "on gathered, dequantized "
                                               "ring K/V, window mask",
           "paged_flash_verify_window": "scaled_dot_product_attention on "
                                        "gathered ring K/V, verify and "
                                        "window mask",
           "paged_flash_verify_int8kv_window": "scaled_dot_product_attention "
                                               "on gathered, dequantized "
                                               "ring K/V, verify and window "
                                               "mask",
           "paged_flash_prefill_window": "scaled_dot_product_attention on "
                                         "gathered ring K/V, offset-causal "
                                         "window mask",
           "paged_flash_prefill_int8kv_window": "scaled_dot_product_attention"
                                                " on gathered, dequantized "
                                                "ring K/V, offset-causal "
                                                "window mask",
           "fused_qkv_append_kv_layer": "torch._weight_int8pack_mm of the "
                                        "qkv product alone",
           "paged_append_decode_fp8kv": "PyTorch's e4m3 cast + "
                                        "index_put_ x2",
           "paged_append_prefill_fp8kv": "PyTorch's e4m3 cast "
                                         "+ index_copy_ x2",
           "paged_append_span_fp8kv": "PyTorch's e4m3 cast + "
                                      "index_put_ x2",
           "paged_flash_decode_fp8kv": "gather + cast to q's dtype + "
                                       "scaled_dot_product_attention (cast "
                                       "included)",
           "paged_flash_verify_fp8kv": "gather + cast to q's dtype + "
                                       "scaled_dot_product_attention, "
                                       "verify mask (cast included)",
           "fused_qkv_append_fp8kv": "torch._weight_int8pack_mm of the qkv "
                                     "product alone",
           "paged_flash_prefill_fp8kv": "gather + cast to q's dtype + "
                                        "scaled_dot_product_attention, "
                                        "offset-causal mask (cast included)",
           "flash_prefill_d256": "scaled_dot_product_attention, causal (K/V "
                                 "repeated per group)",
           "paged_flash_decode_d256": "scaled_dot_product_attention on "
                                      "gathered K/V (repeated per group)",
           "paged_flash_prefill_d256": "scaled_dot_product_attention on "
                                       "gathered K/V (repeated per group), "
                                       "offset-causal mask",
           "flash_decode_d256": "scaled_dot_product_attention on the arena "
                                "slice (repeated per group), length mask",
           "fused_qkv_append_mma_d256": "torch._weight_int8pack_mm of the "
                                        "qkv product alone",
           "fused_qkv_append_d256": "torch._weight_int8pack_mm of the qkv "
                                    "product alone",
           "flash_prefill_cap_d256": "scaled_dot_product_attention, causal "
                                     "(K/V repeated per group; uncapped)",
           "flash_prefill_window_cap_d256": "scaled_dot_product_attention, "
                                            "window mask (K/V repeated per "
                                            "group; uncapped)",
           "paged_flash_decode_cap_d256": "scaled_dot_product_attention on "
                                          "gathered K/V (repeated per "
                                          "group; uncapped)",
           "paged_flash_decode_window_cap_d256": "scaled_dot_product_"
                                                 "attention on gathered ring "
                                                 "K/V, window mask "
                                                 "(uncapped)",
           "paged_flash_prefill_cap_d256": "scaled_dot_product_attention on "
                                           "gathered K/V, offset-causal mask "
                                           "(uncapped)",
           "paged_flash_prefill_window_cap_d256": "scaled_dot_product_"
                                                  "attention on gathered "
                                                  "ring K/V, offset-causal "
                                                  "window mask (uncapped)",
           "fused_qkv_append_kv_layer_d256": "torch._weight_int8pack_mm of "
                                             "the qkv product alone",
           "flash_decode_window": "scaled_dot_product_attention on the "
                                  "arena slice (repeated per group), "
                                  "window mask",
           "flash_decode_cap_d256": "scaled_dot_product_attention on the "
                                    "arena slice (repeated per group), "
                                    "length mask (uncapped)",
           "flash_decode_window_cap_d256": "scaled_dot_product_attention on "
                                           "the arena slice (repeated per "
                                           "group), window mask (uncapped)",
           "paged_flash_verify_d256": "scaled_dot_product_attention on "
                                      "gathered K/V (repeated per group), "
                                      "verify mask",
           "paged_flash_verify_window_d256": "scaled_dot_product_attention "
                                             "on gathered ring K/V "
                                             "(repeated per group), verify "
                                             "and window mask",
           "paged_flash_verify_cap_d256": "scaled_dot_product_attention on "
                                          "gathered K/V (repeated per "
                                          "group), verify mask (uncapped)",
           "paged_flash_verify_window_cap_d256": "scaled_dot_product_"
                                                 "attention on gathered ring "
                                                 "K/V, verify and window "
                                                 "mask (uncapped)",
           "flash_prefill_sinks": "scaled_dot_product_attention, causal "
                                  "(K/V repeated per group; no sinks)",
           "flash_prefill_window_sinks": "scaled_dot_product_attention, "
                                         "window mask (K/V repeated per "
                                         "group; no sinks)",
           "paged_flash_decode_sinks": "scaled_dot_product_attention on "
                                       "gathered K/V (repeated per group; "
                                       "no sinks)",
           "paged_flash_decode_window_sinks": "scaled_dot_product_attention "
                                              "on gathered ring K/V, window "
                                              "mask (no sinks)",
           "paged_flash_prefill_sinks": "scaled_dot_product_attention on "
                                        "gathered K/V, offset-causal mask "
                                        "(no sinks)",
           "paged_flash_prefill_window_sinks": "scaled_dot_product_attention"
                                               " on gathered ring K/V, "
                                               "offset-causal window mask "
                                               "(no sinks)",
           "paged_flash_verify_sinks": "scaled_dot_product_attention on "
                                       "gathered K/V (repeated per group), "
                                       "verify mask (no sinks)",
           "paged_flash_verify_window_sinks": "scaled_dot_product_attention"
                                              " on gathered ring K/V, "
                                              "verify and window mask (no "
                                              "sinks)",
           "flash_decode_sinks": "scaled_dot_product_attention on the arena "
                                 "slice (repeated per group), length mask "
                                 "(no sinks)",
           "flash_decode_window_sinks": "scaled_dot_product_attention on the"
                                        " arena slice (repeated per group), "
                                        "window mask (no sinks)",
           "paged_flash_decode_int8kv_sinks": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), length mask (dequant included; no "
               "sinks)"),
           "paged_flash_decode_int8kv_window_sinks": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), length and window mask (dequant "
               "included; no sinks)"),
           "paged_flash_verify_int8kv_sinks": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), verify mask (dequant included; no "
               "sinks)"),
           "paged_flash_verify_int8kv_window_sinks": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), verify and window mask (dequant "
               "included; no sinks)"),
           "paged_flash_prefill_int8kv_sinks": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), offset-causal mask (dequant included; "
               "no sinks)"),
           "paged_flash_prefill_int8kv_window_sinks": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), offset-causal and window mask (dequant"
               " included; no sinks)"),
           "paged_flash_decode_int8kv_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), length mask (dequant included)"),
           "paged_flash_decode_int8kv_window_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), length and window mask (dequant "
               "included)"),
           "paged_flash_verify_int8kv_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), verify mask (dequant included)"),
           "paged_flash_verify_int8kv_window_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), verify and window mask (dequant "
               "included)"),
           "paged_flash_prefill_int8kv_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), offset-causal mask (dequant included)"),
           "paged_flash_prefill_int8kv_window_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), offset-causal and window mask (dequant"
               " included)"),
           "paged_flash_decode_int8kv_cap_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), length mask (dequant included; "
               "uncapped)"),
           "paged_flash_decode_int8kv_window_cap_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), length and window mask (dequant "
               "included; uncapped)"),
           "paged_flash_verify_int8kv_cap_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), verify mask (dequant included; "
               "uncapped)"),
           "paged_flash_verify_int8kv_window_cap_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), verify and window mask (dequant "
               "included; uncapped)"),
           "paged_flash_prefill_int8kv_cap_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), offset-causal mask (dequant included; "
               "uncapped)"),
           "paged_flash_prefill_int8kv_window_cap_d256": (
               "scaled_dot_product_attention on gathered, dequantized K/V "
               "(repeated per group), offset-causal and window mask (dequant"
               " included; uncapped)"),
           "fused_qkv_append_int8kv_d256": (
               "torch._weight_int8pack_mm of the qkv product alone"),
           "fused_qkv_append_int8kv_kv_layer_d256": (
               "torch._weight_int8pack_mm of the qkv product alone"),
           "paged_append_decode_quant_d256": (
               "torch quantize ops + index_put_ x4"),
           "paged_append_prefill_quant_d256": (
               "torch quantize ops + index_copy_ x4"),
           "paged_flash_decode_fp8kv_window": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), length and window mask (cast "
               "included)"),
           "paged_flash_verify_fp8kv_window": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), verify and window mask (cast "
               "included)"),
           "paged_flash_prefill_fp8kv_window": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), offset-causal and window mask "
               "(cast included)"),
           "fused_qkv_append_fp8kv_kv_layer": (
               "torch._weight_int8pack_mm of the qkv product alone"),
           "paged_flash_decode_fp8kv_sinks": (
               "scaled_dot_product_attention on gathered K/V cast from e4m3 "
               "(repeated per group), length mask (cast included; no "
               "sinks)"),
           "paged_flash_decode_fp8kv_window_sinks": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), length and window mask (cast "
               "included; no sinks)"),
           "paged_flash_verify_fp8kv_sinks": (
               "scaled_dot_product_attention on gathered K/V cast from e4m3 "
               "(repeated per group), verify mask (cast included; no "
               "sinks)"),
           "paged_flash_verify_fp8kv_window_sinks": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), verify and window mask (cast "
               "included; no sinks)"),
           "paged_flash_prefill_fp8kv_sinks": (
               "scaled_dot_product_attention on gathered K/V cast from e4m3 "
               "(repeated per group), offset-causal mask (cast included; no "
               "sinks)"),
           "paged_flash_prefill_fp8kv_window_sinks": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), offset-causal and window mask "
               "(cast included; no sinks)"),
           "paged_flash_decode_fp8kv_cap_d256": (
               "scaled_dot_product_attention on gathered K/V cast from e4m3 "
               "(repeated per group), length mask (cast included; uncapped)"),
           "paged_flash_decode_fp8kv_window_cap_d256": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), length and window mask (cast "
               "included; uncapped)"),
           "paged_flash_verify_fp8kv_cap_d256": (
               "scaled_dot_product_attention on gathered K/V cast from e4m3 "
               "(repeated per group), verify mask (cast included; uncapped)"),
           "paged_flash_verify_fp8kv_window_cap_d256": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), verify and window mask (cast "
               "included; uncapped)"),
           "paged_flash_prefill_fp8kv_cap_d256": (
               "scaled_dot_product_attention on gathered K/V cast from e4m3 "
               "(repeated per group), offset-causal mask (cast included; "
               "uncapped)"),
           "paged_flash_prefill_fp8kv_window_cap_d256": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), offset-causal and window mask (cast"
               " included; uncapped)"),
           "paged_flash_decode_fp8kv_d256": (
               "scaled_dot_product_attention on gathered K/V cast from e4m3 "
               "(repeated per group), length mask (cast included)"),
           "paged_flash_decode_fp8kv_window_d256": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), length and window mask (cast "
               "included)"),
           "paged_flash_verify_fp8kv_d256": (
               "scaled_dot_product_attention on gathered K/V cast from e4m3 "
               "(repeated per group), verify mask (cast included)"),
           "paged_flash_verify_fp8kv_window_d256": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), verify and window mask (cast "
               "included)"),
           "paged_flash_prefill_fp8kv_d256": (
               "scaled_dot_product_attention on gathered K/V cast from e4m3 "
               "(repeated per group), offset-causal mask (cast included)"),
           "paged_flash_prefill_fp8kv_window_d256": (
               "scaled_dot_product_attention on gathered ring K/V cast from "
               "e4m3 (repeated per group), offset-causal and window mask (cast"
               " included)"),
           "paged_append_decode_fp8kv_d256": "PyTorch's e4m3 cast + "
                                             "index_put_ x2",
           "paged_append_prefill_fp8kv_d256": "PyTorch's e4m3 cast + "
                                              "index_copy_ x2",
           "paged_append_span_fp8kv_d256": "PyTorch's e4m3 cast + "
                                           "index_put_ x2",
           "fused_qkv_append_fp8kv_d256": (
               "torch._weight_int8pack_mm of the qkv product alone"),
           "fused_qkv_append_fp8kv_kv_layer_d256": (
               "torch._weight_int8pack_mm of the qkv product alone"),
           "kv_append_fp8kv": "PyTorch's e4m3 cast + index_copy_ x2 "
                              "(flattened rows)",
           "kv_append_fp8kv_d256": "PyTorch's e4m3 cast + index_copy_ x2 "
                                   "(flattened rows)",
           "flash_decode_fp8kv": "scaled_dot_product_attention on the "
                                 "arena slice cast from e4m3, length mask "
                                 "(cast included)",
           "flash_decode_fp8kv_window": (
               "scaled_dot_product_attention on the arena slice cast from "
               "e4m3 (repeated per group), window mask (cast included)"),
           "flash_decode_fp8kv_d256": (
               "scaled_dot_product_attention on the arena slice cast from "
               "e4m3 (repeated per group), length mask (cast included)"),
           "flash_decode_fp8kv_cap_d256": (
               "scaled_dot_product_attention on the arena slice cast from "
               "e4m3 (repeated per group), length mask (cast included; "
               "uncapped)"),
           "flash_decode_fp8kv_window_cap_d256": (
               "scaled_dot_product_attention on the arena slice cast from "
               "e4m3 (repeated per group), window mask (cast included; "
               "uncapped)"),
           "flash_decode_fp8kv_sinks": (
               "scaled_dot_product_attention on the arena slice cast from "
               "e4m3 (repeated per group), length mask (cast included; no "
               "sinks)"),
           "flash_decode_fp8kv_window_sinks": (
               "scaled_dot_product_attention on the arena slice cast from "
               "e4m3 (repeated per group), window mask (cast included; no "
               "sinks)"),
           "fused_qkv_append_fp8kv_dense": (
               "torch._weight_int8pack_mm of the qkv product alone"),
           "fused_qkv_append_fp8kv_dense_d256": (
               "torch._weight_int8pack_mm of the qkv product alone"),
           "paged_append_decode_shared": "index_put_",
           "paged_append_prefill_shared": "index_copy_",
           "flash_prefill_shared": "scaled_dot_product_attention, causal, "
                                   "K as V, enable_gqa",
           "paged_flash_decode_shared": (
               "scaled_dot_product_attention on the gathered latent rows, K "
               "as V, enable_gqa, length mask"),
           "paged_flash_prefill_shared": (
               "scaled_dot_product_attention on the gathered latent rows, K "
               "as V, enable_gqa, offset-causal mask"),
           "fused_wo_ffn": "torch._weight_int8pack_mm x3 + eager rmsnorm "
                           "and SwiGLU",
           "flash_decode_dyn": "scaled_dot_product_attention on the arena "
                               "slice, length mask"}


def phase_kernels(torch, results):
    dev = torch.device("cuda")
    extra: list = []
    reset_counts()
    lap = Laps()

    def run(check, *args, **kw):
        check(torch, dev, *args, **kw)
        lap(check.__name__)

    run(check_append_decode, results)
    run(check_append_prefill, results)
    run(check_flash_prefill, results)
    run(check_paged_decode, results, extra)
    run(check_quantized_matmul, results, extra)
    run(check_fused_qkv, results, extra)
    run(check_fused_ffn, results, extra)
    run(check_paged_prefill, results, extra)
    run(check_append_decode_quant, results)
    run(check_append_prefill_quant, results)
    run(check_paged_decode_int8kv, results, extra)
    run(check_fused_qkv_int8kv, results, extra)
    run(check_paged_prefill_int8kv, results, extra)
    run(check_append_span, results)
    run(check_paged_verify, results, extra, kv="bf16")
    run(check_paged_verify, results, extra, kv="int8")
    run(check_kv_append, results, extra)
    run(check_flash_decode, results, extra)
    run(check_fused_qkv_dense, results, extra)
    run(check_quantized_matmul_int4, results, extra)
    run(check_quantized_matmul_w8a8, results, extra)
    run(check_quantizers)
    run(check_flash_prefill_window, results, extra)
    run(check_paged_decode_window, results, extra)
    run(check_paged_prefill_window, results, extra)
    run(check_fused_qkv_kv_layer, results, extra)
    run(check_fused_wo_ffn, results, extra)
    run(check_flash_decode_dyn, results, extra)
    # FP8 (e4m3) KV: the conversion, then forms 1e, 2e, 11e, 4e, 4ve, 8e, 6e
    run(check_e4m3_conversion)
    run(check_append_fp8kv, results)
    run(check_paged_decode_fp8kv, results, extra)
    run(check_paged_verify, results, extra, kv="fp8")
    run(check_paged_prefill_fp8kv, results, extra)
    run(check_fused_qkv_fp8kv, results, extra)
    # head_dim 256 (Gemma-2B): forms 1, 2, 3, 4, 13, 8 and 6 at its shapes
    run(check_head_dim_256, results, extra)
    # Gemma-2-2B: the soft cap (3c, 3wc, 4c, 4wc, 8c, 8wc) and 6k at D 256
    run(check_gemma2, results, extra)
    # Gemma-2 on the dense arena and under speculation: 13w, 13c, 13wc,
    # 4v/256, 4vw/256, 4vc, 4vwc
    run(check_gemma2_dense, results, extra)
    # gpt-oss-20b: attention sinks (3s, 3ws, 4s, 4ws, 8s, 8ws) at D 64
    run(check_gpt_oss, results, extra)
    # and on verify rows and the dense arena (4vs, 4vws, 13s, 13ws)
    run(check_gpt_oss_spec_dense, results, extra)
    # sinks and the cap over INT8 pools, the INT8-KV forms at D 256 (4qs,
    # 4qws, 4vqs, 4vqws, 8qs, 8qws; 4qc/256 .. 8qwc/256; 4q/256 .. 8qw/256;
    # 6q/256, 9/256, 10/256)
    run(check_int8kv_options, results, extra)
    # sinks and windows over e4m3 pools (4es, 4ews, 4ves, 4vews, 8es, 8ews;
    # 4ew, 4vew, 8ew; 6ek is in check_fused_qkv_fp8kv)
    run(check_fp8kv_options, results, extra)
    # FP8 KV on the dense arena (12e, 13e, 13ew, 13ec, 13ewc, 13es, 13ews,
    # 6de and their D-256 forms)
    run(check_dense_fp8kv, results, extra)
    # absorbed MLA's shared-KV forms (1l, 2l, 3l/640, 4l/640, 8l/640; 4l
    # and 8l at D 128)
    run(check_mla, results, extra)
    torch.cuda.empty_cache()
    lap.print("phase-3")
    # every launch of this phase (the checks, their timing): kernels 16
    # and 17 run on no path, as in the JAX package, so these are theirs
    phase3_launches.update({name: kern.launches
                            for name, (kern, _ref) in _wrappers().items()})
    rows = [(name, "main path shape", r) for name, r in results.items()]
    rows += [(name, tag, r) for name, tag, r in extra]
    for name, tag, r in rows:
        cold = (f", {r['cold_ms']:.6g} over weight copies past the L2"
                if "cold_ms" in r else "")
        regime = f" [{r['regime']}]" if "regime" in r else ""
        lib_ms = r["library_ms"]
        print(f"[kernels] {name} ({tag}){regime}: {r['ms']:.6g} ms{cold} "
              f"(plain {r['plain_ms']:.6g}, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.6g}'} "
              f"[{r.get('library', LIBRARY[name])}], bound "
              f"{r['bound_ms']:.6g} by {r['bound_by']})", flush=True)


def int4_regime_launches(mm) -> dict:
    """``matmul.INT4_REGIME_LAUNCHES``, or an empty count for a package
    without the INT4 tensor-core regimes (this script also times an
    earlier tree of the package, whose INT4 products then count in
    neither regime row)."""
    return getattr(mm, "INT4_REGIME_LAUNCHES", {})


def int4_regime(m: int, k: int, n: int, group: int, dtype) -> str:
    """The kernel the INT4 wrapper picks for m rows x [k, n] weights
    (``matmul.int4_regime``; "fma" for a package without it)."""
    from simplellminference_tpu_torch.ops import matmul as mm
    fn = getattr(mm, "int4_regime", None)
    return fn(m, k // 2, n, group, dtype) if fn else "fma"


def int4_regime_counts(cfg, m: int, head_rows: int, layers: int) -> dict:
    """Launches of the INT4 tensor-core regime rows for one dispatch or
    step of ``m`` rows with bf16 activations and per-channel scales (as
    bench.py --quant int4 draws them): each layer's wqkv, wo, gate_up and
    down at m rows, the LM head at ``head_rows``. A product an FMA kernel
    takes counts in neither row."""
    import torch
    h, i = cfg.hidden_size, cfg.intermediate_size
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    want = {"quantized_matmul_int4_mma": 0, "quantized_matmul_int4_wgmma": 0}
    for k, n, rows, count in ((h, qkv, m, layers),
                              (cfg.num_heads * cfg.head_dim, h, m, layers),
                              (h, 2 * i, m, layers), (i, h, m, layers),
                              (h, cfg.vocab_size, head_rows, 1)):
        regime = int4_regime(rows, k, n, k, torch.bfloat16)
        if regime in ("mma", "wgmma"):
            want["quantized_matmul_int4_" + regime] += count
    return want


def regime_rows(want: dict, cfg) -> dict:
    """``want`` with the rows of the tensor-core regimes of kernels 5, 6, 7
    and 15 filled for a path of ``cfg``'s model: every fused_ffn call
    (m <= 64 rows of ``cfg.dtype``) in ``fused_ffn_mma`` when
    ``ffn_fused.ffn_regime`` sends the model's H and I there; every call
    of the four fused qkv forms in ``fused_qkv_append_mma`` when
    ``qkv_fused.qkv_regime`` sends the model's H and qkv columns there,
    else in ``fused_qkv_append_fma``; every quantized_matmul call of at
    most 8 rows (those not in ``quantized_matmul_mma``: bf16 activations,
    per-channel scales) in ``quantized_matmul_rows_mma`` when
    ``matmul.tiled_regime`` sends the model's wqkv, wo and head there,
    else in ``quantized_matmul_rows`` (the FMA kernel); and each W8A8
    call whose layer product (wqkv, wo, gate_up, down; per-channel scales)
    ``matmul.w8a8_regime`` sends to the int8 tensor cores in
    ``quantized_matmul_w8a8_wgmma``. A regime row stays 0 for a package
    without the regime (an earlier tree timed beside this one)."""
    import torch

    from simplellminference_tpu_torch.ops import ffn_fused as ff
    from simplellminference_tpu_torch.ops import matmul as mm
    from simplellminference_tpu_torch.ops import qkv_fused as qf
    out = dict(want)
    h, i = cfg.hidden_size, cfg.intermediate_size
    dtype = getattr(torch, cfg.dtype)
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    qreg = getattr(qf, "qkv_regime", None)
    forms = sum(want[k] for k in (
        "fused_qkv_append", "fused_qkv_append_dense",
        "fused_qkv_append_int8kv", "fused_qkv_append_kv_layer",
        "fused_qkv_append_fp8kv"))
    on_mma = qreg is not None and qreg(8, h, qkv, cfg.head_dim,
                                       dtype) == "mma"
    out["fused_qkv_append_mma"] = forms if on_mma else 0
    out["fused_qkv_append_fma"] = (0 if on_mma else forms
                                   if qreg is not None else 0)
    few = want["quantized_matmul"] - want["quantized_matmul_mma"]
    few_shapes = [(h, qkv), (cfg.num_heads * cfg.head_dim, h),
                  (h, cfg.vocab_size)]
    if cfg.num_experts:
        # the folded experts of a decode step (ops/moe.py) on kernel 5
        e, ie = cfg.num_experts, cfg.expert_intermediate_size
        few_shapes += [(h, e * 2 * ie), (e * ie, h)]
    elif cfg.hidden_act != "silu":
        # GeGLU (Gemma): no fused FFN, so its products run on kernel 5
        few_shapes += [(h, 2 * i), (i, h)]
    rmma = all(mm.tiled_regime(8, k, n, k, dtype) == "rmma"
               for k, n in few_shapes)
    out["quantized_matmul_rows_mma"] = few if rmma else 0
    out["quantized_matmul_rows"] = 0 if rmma else few
    ffn = getattr(ff, "ffn_regime", None)
    out["fused_ffn_mma"] = (want["fused_ffn"] if ffn is not None and ffn(
        8, h, i, dtype) == "mma" else 0)
    w8 = getattr(mm, "w8a8_regime", None)
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    shapes = ((h, qkv), (cfg.num_heads * cfg.head_dim, h), (h, 2 * i), (i, h))
    wg = sum(w8 is not None and w8(128, k, n, k) == "wgmma"
             for k, n in shapes)
    out["quantized_matmul_w8a8_wgmma"] = (want["quantized_matmul_w8a8"]
                                          // 4 * wg)
    # head_dim 256: every launch of kernels 3, 4, 8, 13 and 6 is a D-256 one
    d256 = cfg.head_dim == 256
    for row, of in (("flash_prefill_d256", "flash_prefill"),
                    ("paged_flash_decode_d256", "paged_flash_decode"),
                    ("paged_flash_prefill_d256", "paged_flash_prefill"),
                    ("flash_decode_d256", "flash_decode"),
                    ("fused_qkv_append_mma_d256", "fused_qkv_append_mma"),
                    ("fused_qkv_append_d256", "fused_qkv_append_fma"),
                    ("fused_qkv_append_kv_layer_d256",
                     "fused_qkv_append_kv_layer"),
                    ("paged_flash_verify_d256", "paged_flash_verify"),
                    ("paged_flash_verify_window_d256",
                     "paged_flash_verify_window")):
        out[row] = out[of] if d256 else 0
    # Gemma-2: every attention launch of a capped model is a capped one
    cap = d256 and bool(cfg.attn_logit_softcap)
    int8kv, fp8kv = ([f"paged_flash_{k}_{kv}{w}" for k in ("decode", "verify",
                                                            "prefill")
                      for w in ("", "_window")] for kv in ("int8kv", "fp8kv"))
    for form in ("flash_prefill", "flash_prefill_window",
                 "paged_flash_decode", "paged_flash_decode_window",
                 "paged_flash_prefill", "paged_flash_prefill_window",
                 "flash_decode", "flash_decode_window",
                 "paged_flash_verify", "paged_flash_verify_window", *int8kv,
                 *fp8kv, "flash_decode_fp8kv", "flash_decode_fp8kv_window"):
        out[f"{form}_cap_d256"] = out[form] if cap else 0
    # GPT-OSS: every attention launch of a model with sinks is a sink one
    sinks = cfg.head_dim == 64 and cfg.attn_sinks
    for form in ("flash_prefill", "flash_prefill_window",
                 "paged_flash_decode", "paged_flash_decode_window",
                 "paged_flash_prefill", "paged_flash_prefill_window",
                 "paged_flash_verify", "paged_flash_verify_window",
                 "flash_decode", "flash_decode_window", *int8kv, *fp8kv,
                 "flash_decode_fp8kv", "flash_decode_fp8kv_window"):
        out[f"{form}_sinks"] = out[form] if sinks else 0
    # INT8 and FP8 KV at D 256: the attention forms, 6q, 9 and 10, 6e, 1e,
    # 2e and 11e (6q's launches with a kv_layer come from windowed(): the
    # grouped engine's; 6ek's are every kv_layer launch of 6e)
    for form in (*int8kv, "fused_qkv_append_int8kv",
                 "paged_append_decode_quant", "paged_append_prefill_quant",
                 *fp8kv, "fused_qkv_append_fp8kv",
                 "paged_append_decode_fp8kv", "paged_append_prefill_fp8kv",
                 "paged_append_span_fp8kv", "fused_qkv_append_fp8kv_kv_layer",
                 "kv_append_fp8kv", "flash_decode_fp8kv",
                 "fused_qkv_append_fp8kv_dense"):
        out[f"{form}_d256"] = out[form] if d256 else 0
    out["fused_qkv_append_int8kv_kv_layer_d256"] = out.get(
        "fused_qkv_append_int8kv_kv_layer_d256", 0) if d256 else 0
    return out


class _Regime:
    """The launch count of one regime of a wrapper with a kernel per
    regime (kernel 5: ``matmul.REGIME_LAUNCHES``; the INT4 product:
    ``matmul.INT4_REGIME_LAUNCHES``), read and reset like a wrapper's own
    ``launches``."""

    def __init__(self, counts: dict, key: str):
        self.counts, self.key = counts, key

    @property
    def launches(self) -> int:
        return self.counts.get(self.key, 0)

    @launches.setter
    def launches(self, n: int) -> None:
        self.counts[self.key] = n


def _wrappers():
    from simplellminference_tpu_torch.ops import ffn_fused as ff
    from simplellminference_tpu_torch.ops import kv_append as ka
    from simplellminference_tpu_torch.ops import matmul as mm
    from simplellminference_tpu_torch.ops import paged_append as pa
    from simplellminference_tpu_torch.ops import qkv_fused as qf
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    from simplellminference_tpu_torch.ops.attention import (
        flash_decode_dyn as fdd)
    from simplellminference_tpu_torch.ops.attention import flash_prefill as fp
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    from simplellminference_tpu_torch.ops.attention import paged_prefill as pp
    return {"paged_append_decode": (pa.paged_append_decode,
                                    pa.paged_append_decode_ref),
            "paged_append_prefill": (pa.paged_append_prefill,
                                     pa.paged_append_prefill_ref),
            "flash_prefill": (fp.flash_prefill, fp.flash_prefill_ref),
            "paged_flash_decode": (pd.paged_flash_decode,
                                   pd.paged_flash_decode_ref),
            "quantized_matmul": (mm.quantized_matmul,
                                 mm.quantized_matmul_ref),
            "quantized_matmul_mma": (_Regime(mm.REGIME_LAUNCHES, "mma"),
                                     mm.quantized_matmul_ref),
            "quantized_matmul_rows_mma": (
                _Regime(mm.REGIME_LAUNCHES, "rmma"), mm.quantized_matmul_ref),
            # the few-rows FMA regime: no kernels-line row, but phase 4
            # holds its count (0 on every bf16 path where 5r takes it)
            "quantized_matmul_rows": (_Regime(mm.REGIME_LAUNCHES, "rows"),
                                      mm.quantized_matmul_ref),
            "fused_qkv_append": (qf.fused_qkv_append,
                                 qf.fused_qkv_append_ref),
            "fused_qkv_append_mma": (
                _Regime(getattr(qf, "QKV_REGIME_LAUNCHES", {}), "mma"),
                qf.fused_qkv_append_ref),
            "fused_qkv_append_fma": (
                _Regime(getattr(qf, "QKV_REGIME_LAUNCHES", {}), "fma"),
                qf.fused_qkv_append_ref),
            "fused_ffn": (ff.fused_ffn, ff.fused_ffn_ref),
            "fused_ffn_mma": (
                _Regime(getattr(ff, "FFN_REGIME_LAUNCHES", {}), "mma"),
                ff.fused_ffn_ref),
            "paged_flash_prefill": (pp.paged_flash_prefill,
                                    pp.paged_flash_prefill_ref),
            "paged_append_decode_quant": (pa.paged_append_decode_quant,
                                          pa.paged_append_decode_quant_ref),
            "paged_append_prefill_quant": (pa.paged_append_prefill_quant,
                                           pa.paged_append_prefill_quant_ref),
            "paged_flash_decode_int8kv": (pd.paged_flash_decode_int8kv,
                                          pd.paged_flash_decode_ref),
            "fused_qkv_append_int8kv": (qf.fused_qkv_append_int8kv,
                                        qf.fused_qkv_append_ref),
            "paged_flash_prefill_int8kv": (pp.paged_flash_prefill_int8kv,
                                           pp.paged_flash_prefill_ref),
            "paged_append_span": (pa.paged_append_span,
                                  pa.paged_append_span_ref),
            "paged_flash_verify": (pd.paged_flash_verify,
                                   pd.paged_flash_verify_ref),
            "paged_flash_verify_int8kv": (pd.paged_flash_verify_int8kv,
                                          pd.paged_flash_verify_ref),
            "kv_append": (ka.kv_append, ka.kv_append_ref),
            "flash_decode": (fd.flash_decode, fd.flash_decode_ref),
            "flash_decode_window": (fd.flash_decode_window,
                                    fd.flash_decode_ref),
            "fused_qkv_append_dense": (qf.fused_qkv_append_dense,
                                       qf.fused_qkv_append_ref),
            "quantized_matmul_int4": (mm.quantized_matmul_int4,
                                      mm.quantized_matmul_int4_ref),
            "quantized_matmul_int4_zs": (mm.quantized_matmul_int4_zs,
                                         mm.quantized_matmul_int4_ref),
            "quantized_matmul_int4_mma": (
                _Regime(int4_regime_launches(mm), "mma"),
                mm.quantized_matmul_int4_ref),
            "quantized_matmul_int4_wgmma": (
                _Regime(int4_regime_launches(mm), "wgmma"),
                mm.quantized_matmul_int4_ref),
            "quantized_matmul_w8a8": (mm.quantized_matmul_w8a8,
                                      mm.quantized_matmul_w8a8_ref),
            "quantized_matmul_w8a8_wgmma": (
                _Regime(getattr(mm, "W8A8_REGIME_LAUNCHES", {}), "wgmma"),
                mm.quantized_matmul_w8a8_ref),
            "flash_prefill_window": (fp.flash_prefill_window,
                                     fp.flash_prefill_ref),
            "paged_flash_decode_window": (pd.paged_flash_decode_window,
                                          pd.paged_flash_decode_ref),
            "paged_flash_decode_int8kv_window": (
                pd.paged_flash_decode_int8kv_window, pd.paged_flash_decode_ref),
            "paged_flash_verify_window": (pd.paged_flash_verify_window,
                                          pd.paged_flash_verify_ref),
            "paged_flash_verify_int8kv_window": (
                pd.paged_flash_verify_int8kv_window, pd.paged_flash_verify_ref),
            "paged_flash_prefill_window": (pp.paged_flash_prefill_window,
                                           pp.paged_flash_prefill_ref),
            "paged_flash_prefill_int8kv_window": (
                pp.paged_flash_prefill_int8kv_window,
                pp.paged_flash_prefill_ref),
            "fused_qkv_append_kv_layer": (qf.fused_qkv_append_kv_layer,
                                          qf.fused_qkv_append_ref),
            "paged_append_decode_fp8kv": (pa.paged_append_decode_fp8kv,
                                          pa.paged_append_decode_ref),
            "paged_append_prefill_fp8kv": (pa.paged_append_prefill_fp8kv,
                                           pa.paged_append_prefill_ref),
            "paged_append_span_fp8kv": (pa.paged_append_span_fp8kv,
                                        pa.paged_append_span_ref),
            "paged_flash_decode_fp8kv": (pd.paged_flash_decode_fp8kv,
                                         pd.paged_flash_decode_ref),
            "paged_flash_verify_fp8kv": (pd.paged_flash_verify_fp8kv,
                                         pd.paged_flash_verify_ref),
            "fused_qkv_append_fp8kv": (qf.fused_qkv_append_fp8kv,
                                       qf.fused_qkv_append_ref),
            "paged_flash_prefill_fp8kv": (pp.paged_flash_prefill_fp8kv,
                                          pp.paged_flash_prefill_ref),
            "paged_flash_decode_fp8kv_window": (
                pd.paged_flash_decode_fp8kv_window, pd.paged_flash_decode_ref),
            "paged_flash_verify_fp8kv_window": (
                pd.paged_flash_verify_fp8kv_window, pd.paged_flash_verify_ref),
            "paged_flash_prefill_fp8kv_window": (
                pp.paged_flash_prefill_fp8kv_window,
                pp.paged_flash_prefill_ref),
            "fused_qkv_append_fp8kv_kv_layer": (
                _Regime(getattr(qf, "KV_LAYER_LAUNCHES", {}),
                        "fused_qkv_append_fp8kv"), qf.fused_qkv_append_ref),
            "flash_prefill_d256": (
                _Regime(getattr(fp, "D256_LAUNCHES", {}), "flash_prefill"),
                fp.flash_prefill_ref),
            "paged_flash_decode_d256": (
                _Regime(getattr(pd, "D256_LAUNCHES", {}),
                        "paged_flash_decode"), pd.paged_flash_decode_ref),
            "paged_flash_prefill_d256": (
                _Regime(getattr(pp, "D256_LAUNCHES", {}),
                        "paged_flash_prefill"), pp.paged_flash_prefill_ref),
            "flash_decode_d256": (
                _Regime(getattr(fd, "D256_LAUNCHES", {}), "flash_decode"),
                fd.flash_decode_ref),
            "fused_qkv_append_mma_d256": (
                _Regime(getattr(qf, "D256_LAUNCHES", {}), "mma"),
                qf.fused_qkv_append_ref),
            "fused_qkv_append_d256": (
                _Regime(getattr(qf, "D256_LAUNCHES", {}), "fma"),
                qf.fused_qkv_append_ref),
            **{f"{form}_cap_d256": (
                _Regime(getattr(fp, "CAP_LAUNCHES", {}), (form, 256)), ref)
               for form, ref in (
                   ("flash_prefill", fp.flash_prefill_ref),
                   ("flash_prefill_window", fp.flash_prefill_ref),
                   ("paged_flash_decode", pd.paged_flash_decode_ref),
                   ("paged_flash_decode_window", pd.paged_flash_decode_ref),
                   ("paged_flash_prefill", pp.paged_flash_prefill_ref),
                   ("paged_flash_prefill_window",
                    pp.paged_flash_prefill_ref),
                   ("flash_decode", fd.flash_decode_ref),
                   ("flash_decode_window", fd.flash_decode_ref),
                   ("paged_flash_verify", pd.paged_flash_verify_ref),
                   ("paged_flash_verify_window",
                    pd.paged_flash_verify_ref))},
            **{f"{form}_d256": (
                _Regime(getattr(pd, "D256_LAUNCHES", {}), form),
                pd.paged_flash_verify_ref)
               for form in ("paged_flash_verify",
                            "paged_flash_verify_window")},
            "fused_qkv_append_kv_layer_d256": (
                _Regime(getattr(qf, "D256_FORM_LAUNCHES", {}),
                        "fused_qkv_append_kv_layer"),
                qf.fused_qkv_append_ref),
            # the sink forms at gpt-oss-20b's head_dim 64
            **{f"{form}_sinks": (
                _Regime(getattr(fp, "SINK_LAUNCHES", {}), (form, 64)), ref)
               for form, ref in (
                   ("flash_prefill", fp.flash_prefill_ref),
                   ("flash_prefill_window", fp.flash_prefill_ref),
                   ("paged_flash_decode", pd.paged_flash_decode_ref),
                   ("paged_flash_decode_window", pd.paged_flash_decode_ref),
                   ("paged_flash_prefill", pp.paged_flash_prefill_ref),
                   ("paged_flash_prefill_window",
                    pp.paged_flash_prefill_ref),
                   ("paged_flash_verify", pd.paged_flash_verify_ref),
                   ("paged_flash_verify_window", pd.paged_flash_verify_ref),
                   ("flash_decode", fd.flash_decode_ref),
                   ("flash_decode_window", fd.flash_decode_ref))},
            # the FP8-KV forms with sinks (D 64)
            **{f"{form}_sinks": (
                _Regime(getattr(fp, "SINK_LAUNCHES", {}), (form, 64)), ref)
               for form, ref in (
                   ("paged_flash_decode_fp8kv", pd.paged_flash_decode_ref),
                   ("paged_flash_decode_fp8kv_window",
                    pd.paged_flash_decode_ref),
                   ("paged_flash_verify_fp8kv", pd.paged_flash_verify_ref),
                   ("paged_flash_verify_fp8kv_window",
                    pd.paged_flash_verify_ref),
                   ("paged_flash_prefill_fp8kv", pp.paged_flash_prefill_ref),
                   ("paged_flash_prefill_fp8kv_window",
                    pp.paged_flash_prefill_ref))},
            # the INT8-KV forms with sinks (D 64), at D 256, capped at D 256
            **{f"{form}{suffix}": (
                _Regime(counts, (form, d) if d else form), ref)
               for form, ref in (
                   ("paged_flash_decode_int8kv", pd.paged_flash_decode_ref),
                   ("paged_flash_decode_int8kv_window",
                    pd.paged_flash_decode_ref),
                   ("paged_flash_verify_int8kv", pd.paged_flash_verify_ref),
                   ("paged_flash_verify_int8kv_window",
                    pd.paged_flash_verify_ref),
                   ("paged_flash_prefill_int8kv", pp.paged_flash_prefill_ref),
                   ("paged_flash_prefill_int8kv_window",
                    pp.paged_flash_prefill_ref))
               for suffix, counts, d in (
                   ("_sinks", getattr(fp, "SINK_LAUNCHES", {}), 64),
                   ("_cap_d256", getattr(fp, "CAP_LAUNCHES", {}), 256),
                   ("_d256", getattr(pp if "prefill" in form else pd,
                                     "D256_LAUNCHES", {}), 0))},
            # the FP8-KV forms capped and at D 256 (Gemma over FP8 KV)
            **{f"{form}{suffix}": (
                _Regime(counts, (form, 256) if suffix == "_cap_d256"
                        else form), ref)
               for form, ref in (
                   ("paged_flash_decode_fp8kv", pd.paged_flash_decode_ref),
                   ("paged_flash_decode_fp8kv_window",
                    pd.paged_flash_decode_ref),
                   ("paged_flash_verify_fp8kv", pd.paged_flash_verify_ref),
                   ("paged_flash_verify_fp8kv_window",
                    pd.paged_flash_verify_ref),
                   ("paged_flash_prefill_fp8kv", pp.paged_flash_prefill_ref),
                   ("paged_flash_prefill_fp8kv_window",
                    pp.paged_flash_prefill_ref))
               for suffix, counts in (
                   ("_cap_d256", getattr(fp, "CAP_LAUNCHES", {})),
                   ("_d256", getattr(pp if "prefill" in form else pd,
                                     "D256_LAUNCHES", {})))},
            **{f"{form}_d256": (
                _Regime(getattr(qf, "D256_FORM_LAUNCHES", {}), form),
                qf.fused_qkv_append_ref)
               for form in ("fused_qkv_append_int8kv",
                            "fused_qkv_append_int8kv_kv_layer",
                            "fused_qkv_append_fp8kv",
                            "fused_qkv_append_fp8kv_kv_layer")},
            **{f"{form}_d256": (
                _Regime(getattr(pa, "D256_LAUNCHES", {}), form), ref)
               for form, ref in (
                   ("paged_append_decode_quant",
                    pa.paged_append_decode_quant_ref),
                   ("paged_append_prefill_quant",
                    pa.paged_append_prefill_quant_ref),
                   ("paged_append_decode_fp8kv", pa.paged_append_decode_ref),
                   ("paged_append_prefill_fp8kv",
                    pa.paged_append_prefill_ref),
                   ("paged_append_span_fp8kv", pa.paged_append_span_ref))},
            # FP8 KV on the dense arena (12e, 13e and its forms, 6de)
            "kv_append_fp8kv": (ka.kv_append_fp8kv, ka.kv_append_ref),
            "kv_append_fp8kv_d256": (
                _Regime(getattr(ka, "D256_LAUNCHES", {}), "kv_append_fp8kv"),
                ka.kv_append_ref),
            "flash_decode_fp8kv": (fd.flash_decode_fp8kv,
                                   fd.flash_decode_ref),
            "flash_decode_fp8kv_window": (fd.flash_decode_fp8kv_window,
                                          fd.flash_decode_ref),
            "flash_decode_fp8kv_d256": (
                _Regime(getattr(fd, "D256_LAUNCHES", {}),
                        "flash_decode_fp8kv"), fd.flash_decode_ref),
            **{f"{form}{suffix}": (
                _Regime(getattr(fp, counts, {}), (form, d)),
                fd.flash_decode_ref)
               for form in ("flash_decode_fp8kv", "flash_decode_fp8kv_window")
               for suffix, counts, d in (("_cap_d256", "CAP_LAUNCHES", 256),
                                         ("_sinks", "SINK_LAUNCHES", 64))},
            "fused_qkv_append_fp8kv_dense": (
                _Regime(getattr(qf, "DENSE_LAUNCHES", {}),
                        "fused_qkv_append_fp8kv"), qf.fused_qkv_append_ref),
            "fused_qkv_append_fp8kv_dense_d256": (
                _Regime(getattr(qf, "D256_FORM_LAUNCHES", {}),
                        "fused_qkv_append_fp8kv_dense"),
                qf.fused_qkv_append_ref),
            # absorbed MLA's shared-KV forms (1l, 2l, 3l, 4l, 8l)
            "paged_append_decode_shared": (
                pa.paged_append_decode_shared,
                pa.paged_append_decode_shared_ref),
            "paged_append_prefill_shared": (
                pa.paged_append_prefill_shared,
                pa.paged_append_prefill_shared_ref),
            "flash_prefill_shared": (fp.flash_prefill_shared,
                                     fp.flash_prefill_ref),
            "paged_flash_decode_shared": (pd.paged_flash_decode_shared,
                                          pd.paged_flash_decode_ref),
            "paged_flash_prefill_shared": (
                pp.paged_flash_prefill_shared,
                pp.paged_flash_prefill_shared_ref),
            "fused_wo_ffn": (ff.fused_wo_ffn, ff.fused_wo_ffn_ref),
            "flash_decode_dyn": (fdd.flash_decode_dyn,
                                 fdd.flash_decode_dyn_ref)}


def reset_counts():
    for kern, ref in _wrappers().values():
        kern.launches = 0
        ref.cuda_calls = 0


def int8_params(torch, cfg, dev, seed: int = 0) -> dict:
    """Llama weights as bench.py:60-99 draws them for its default INT8
    path, from a seeded generator on the card: random int8 [.., K, N]
    with per-output-channel f32 scales K**-0.5 / 127 (an INT8 LM head
    too, but for a tied model: its head is the bf16 embedding, as in the
    JAX package), a bf16 embedding of int8 draws x 0.002, bf16 norms of
    ones."""
    from simplellminference_tpu_torch.ops.linear import QuantizedWeight
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n, kvn, d, L = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                    cfg.num_layers)
    bf = torch.bfloat16

    def i8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def w(shape):
        return QuantizedWeight(q=i8(shape), scales=torch.full(
            (*shape[:-2], 1, shape[-1]), shape[-2] ** -0.5 / 127.0,
            device=dev))

    params = {"embed": i8((v, h)).to(bf) * 0.002,
              "layers": {"input_norm": torch.ones((L, h), dtype=bf,
                                                  device=dev),
                         "post_norm": torch.ones((L, h), dtype=bf,
                                                 device=dev),
                         "wqkv": w((L, h, (n + 2 * kvn) * d)),
                         "wo": w((L, n * d, h)),
                         "w_gate_up": w((L, h, 2 * i)),
                         "w_down": w((L, i, h))},
              "final_norm": torch.ones((h,), dtype=bf, device=dev)}
    if cfg.sandwich_norms:   # Gemma-2's pre-residual output norms
        for name in ("post_attn_norm", "post_ffn_norm"):
            params["layers"][name] = torch.ones((L, h), dtype=bf,
                                                device=dev)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((h, v))
    return params


def moe_params(torch, cfg, dev, int8: bool, seed: int = 0) -> dict:
    """A mixture-of-experts model's weights (gpt-oss-20b: 42 GB in bf16)
    drawn by the port's ``init_params`` on the card; with ``int8`` the
    layer products and the folded experts quantized per output channel by
    the port's ``quantize_params``, one leaf at a time (each bf16 leaf
    freed as its INT8 form lands: about 21 GB), the router and the biases
    left bf16, and an INT8 LM head as bench.py:60-99 draws one (random
    int8 codes, per-channel scales K**-0.5 / 127)."""
    from simplellminference_tpu_torch.core.config import QuantConfig
    from simplellminference_tpu_torch.models import llama
    from simplellminference_tpu_torch.ops.linear import QuantizedWeight
    from simplellminference_tpu_torch.runtime.weights import quantize_params
    params = llama.init_params(cfg, seed=seed, device=dev)
    if not int8:
        return params
    qc = QuantConfig(mode="int8", group_size=0)
    lw = params["layers"]
    for name in ("w_gate_up", "w_down", "wqkv", "wo"):
        lw[name] = quantize_params({"layers": {name: lw[name]}},
                                   qc)["layers"][name]
        torch.cuda.empty_cache()
    h, v = cfg.hidden_size, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    params["lm_head"] = QuantizedWeight(
        q=torch.randint(-127, 128, (h, v), generator=gen, device=dev,
                        dtype=torch.int8),
        scales=torch.full((1, v), h ** -0.5 / 127.0, device=dev))
    return params


def int4_params(torch, cfg, dev, seed: int = 0) -> dict:
    """Llama weights as bench.py:65-72 draws them for --quant int4, from a
    seeded generator on the card: random split-half packed bytes [.., K/2,
    N] (two codes a byte, every nibble value) with per-output-channel f32
    scales K**-0.5 / 7 (an INT4 LM head too), the embedding and norms of
    :func:`int8_params`."""
    from simplellminference_tpu_torch.ops.linear import QuantizedWeight
    base = int8_params(torch, cfg, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)

    def w4(shape):
        *lead, k, n = shape
        return QuantizedWeight(
            q=torch.randint(-128, 128, (*lead, k // 2, n), generator=gen,
                            device=dev, dtype=torch.int8),
            scales=torch.full((*lead, 1, n), k ** -0.5 / 7.0, device=dev),
            bits=4)

    layers = base["layers"]
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        layers[name] = w4(layers[name].shape)
    base["lm_head"] = w4(base["lm_head"].shape)
    return base


def _nbytes(w) -> int:
    if hasattr(w, "q"):
        zs = 0 if w.zs is None else w.zs.numel() * w.zs.element_size()
        return (w.q.numel() + w.scales.numel() * w.scales.element_size()
                + zs)
    return w.numel() * w.element_size()


def step_weight_bytes(params, batch: int) -> int:
    """Weight bytes one decode step must read: every layer weight, the
    final norm, the LM head, and the batch's embedding rows."""
    e = params["embed"]
    head = params.get("lm_head")
    return (sum(_nbytes(w) for w in params["layers"].values())
            + _nbytes(params["final_norm"])
            + (_nbytes(head) if head is not None else _nbytes(e))
            + batch * e.shape[1] * e.element_size())


def path_launches(int8: bool, layers: int, dispatches, steps: int,
                  kv_dtype: str = "bf16", int4=None,
                  act_quant: bool = False, batch: int = 8,
                  cfg=None) -> dict:
    """Launches each kernel must show in one Engine run of a path.

    ``dispatches``: (attention kernel, rows m = B*S) of each prefill
    dispatch — ``flash_prefill`` for a whole-prompt batch,
    ``paged_flash_prefill`` for a chunk or a suffix batch (its INT8-KV
    form over INT8 KV, ``kv_dtype`` "int8"); each also writes its pages per
    layer (quantizing over INT8 KV). With INT8 weights a dispatch of m > 64
    rows launches 4 quantized_matmul per layer plus the LM head, one of
    m <= 64 rows quantized_matmul for wqkv and wo and fused_ffn per layer
    plus the head; each decode step launches the fused qkv and FFN per
    layer, wo per layer, and the head; with bf16 weights each decode step
    writes K/V with the append kernel. INT8 KV takes each kernel's
    INT8-KV form, FP8 KV ("fp8") its FP8-KV form (the writes 1e and 2e,
    4e, 6e, 8e). ``int4`` (the model config of INT4 weights): every
    product (4 a layer, and the head over the dispatch's sequences, at
    most ``batch``) of every dispatch and step on the INT4 kernel, each
    also in its tensor-core regime's row (:func:`int4_regime_counts`;
    decode steps of ``batch`` rows), K/V written as with bf16 weights. ``act_quant`` (INT8 weights): a dispatch of m >= 128 rows
    runs its 4 layer products on the W8A8 kernel, the head (last rows
    only) on quantized_matmul. Every quantized_matmul of more than 8 rows
    (bf16 activations, per-channel scales) also counts as one of its
    tensor-core regime (quantized_matmul_mma); the head's rows (the
    dispatch's sequences, at most 8) stay on its few-rows kernel. ``cfg``
    (the model's config, when not Llama's): a tied head
    (``tie_word_embeddings``, Gemma) is a bf16 torch.matmul, no launch; a
    GeGLU FFN takes no fused_ffn but two quantized_matmul a layer; a
    mixture of experts (GPT-OSS) takes no fused FFN: its decode step runs
    the folded experts' two products on kernel 5, its prefill the grouped
    experts (dequantized, ``torch.matmul``), so a prefill dispatch launches
    kernel 5 for wqkv and wo only; a QKV bias (GPT-OSS) takes the qkv
    product and the append kernel instead of the fused qkv route."""
    head = int(cfg is None or not cfg.tie_word_embeddings)
    moe = cfg is not None and bool(cfg.num_experts)
    glu = (cfg is None or cfg.hidden_act == "silu") and not moe
    fqkv = cfg is None or not cfg.attention_bias   # the fused qkv's gate
    want = {name: 0 for name in KERNELS}
    q = {"int8": "_quant", "fp8": "_fp8kv"}.get(kv_dtype, "")
    kv = {"int8": "_int8kv", "fp8": "_fp8kv"}.get(kv_dtype, "")
    for attn, m in dispatches:
        want[attn + (kv if attn == "paged_flash_prefill" else "")] += layers
        want["paged_append_prefill" + q] += layers
        if int4:
            want["quantized_matmul_int4"] += 4 * layers + 1
            for name, c in int4_regime_counts(int4, m, min(m, batch),
                                              layers).items():
                want[name] += c
        elif int8 and m <= 64 and glu:
            want["quantized_matmul"] += 2 * layers + head
            want["quantized_matmul_mma"] += 2 * layers * (m > 8)
            want["fused_ffn"] += layers
        elif int8 and act_quant and m >= 128:
            want["quantized_matmul_w8a8"] += 4 * layers
            want["quantized_matmul"] += head
        elif int8:
            per = 2 if moe else 4      # MoE: the experts off kernel 5
            want["quantized_matmul"] += per * layers + head
            want["quantized_matmul_mma"] += per * layers * (m > 8)
    want["paged_flash_decode" + kv] += layers * steps
    if int4:
        want["quantized_matmul_int4"] += (4 * layers + 1) * steps
        for name, c in int4_regime_counts(int4, batch, batch,
                                          layers).items():
            want[name] += c * steps
    if int8:
        want["quantized_matmul"] += (layers * ((1 if glu else 3)
                                               + (not fqkv)) + head) * steps
        want["fused_qkv_append" + kv] += layers * steps * fqkv
        want["fused_ffn"] += layers * steps * glu
    if not int8 or not fqkv:
        want["paged_append_decode" + q] += layers * steps
    return want


def check_launches(path: str, got: dict, want: dict) -> None:
    """Fail, naming every kernel whose count differs, unless each kernel's
    launches in the run equal what the path implies."""
    off = {name: (got[name], n) for name, n in want.items() if got[name] != n}
    require(not off, f"[{path}] launches (got, path implies): {off}")


def read_counts(path: str) -> dict:
    """Every kernel's launch count since :func:`reset_counts`; fails if a
    plain version ran on the card."""
    got = {}
    for name, (kern, ref) in _wrappers().items():
        got[name] = kern.launches
        require(ref.cuda_calls == 0,
                f"[{path}] plain {name} ran on the card {ref.cuda_calls} "
                f"times")
    return got


def count_snapshot() -> dict:
    """Every kernel's launch count and its plain version's card calls now,
    for :func:`counts_since` (a phase-5 check counted like a path without
    resetting the counts other checks read)."""
    return {name: (kern.launches, ref.cuda_calls)
            for name, (kern, ref) in _wrappers().items()}


def counts_since(path: str, snap: dict) -> dict:
    """Each kernel's launches since ``snap``; fails if a plain version ran
    on the card meanwhile."""
    got = {}
    for name, (kern, ref) in _wrappers().items():
        got[name] = kern.launches - snap[name][0]
        require(ref.cuda_calls == snap[name][1],
                f"[{path}] plain {name} ran on the card")
    return got


def kv_bytes(layers: int, tokens: int, kvn: int, d: int,
             kv_dtype: str) -> int:
    """Bytes of K and V for ``tokens`` tokens of every layer: bf16 rows,
    e4m3 rows, or int8 rows and one f32 scale per (token, kv head)."""
    per_head = {"bf16": 2 * d, "fp8": d, "int8": d + 4}[kv_dtype]
    return 2 * layers * tokens * kvn * per_head


def live_kv_bytes(cfg, batch: int, ctx: int, kv_dtype: str) -> int:
    """KV bytes a decode step of ``batch`` rows at context ``ctx`` reads:
    a sliding layer's window (the most its walk reads), a full layer's
    whole context."""
    return sum(kv_bytes(1, batch * (min(ctx, w) if w else ctx),
                        cfg.num_kv_heads, cfg.head_dim, kv_dtype)
               for w in cfg.layer_windows)


def windowed(want: dict, cfg, grouped: bool = True) -> dict:
    """A path's launches under ``cfg``'s sliding-window model in the
    grouped engine: each attention kernel's window form on the sliding
    layers (every layer of Mistral's stack, every other one of Gemma-2's),
    its plain form on the full ones, and 6k for the fused qkv on every
    layer (the grouped engine indexes both pool groups by a group-local
    layer; over INT8 KV 6q with a kv_layer, counted at D 256 in
    ``fused_qkv_append_int8kv_kv_layer_d256``; over FP8 KV 6e with a
    kv_layer, 6ek, in ``fused_qkv_append_fp8kv_kv_layer``). The dense
    arena (``grouped`` False: the Generator) has one layer index, so its
    fused qkv forms stay as they are."""
    share = sum(w is not None for w in cfg.layer_windows) / cfg.num_layers
    ren = {"flash_prefill": "flash_prefill_window",
           "paged_flash_prefill": "paged_flash_prefill_window",
           "paged_flash_decode": "paged_flash_decode_window",
           "paged_flash_verify": "paged_flash_verify_window",
           "flash_decode": "flash_decode_window",
           "paged_flash_prefill_int8kv": "paged_flash_prefill_int8kv_window",
           "paged_flash_decode_int8kv": "paged_flash_decode_int8kv_window",
           "paged_flash_verify_int8kv": "paged_flash_verify_int8kv_window",
           "paged_flash_prefill_fp8kv": "paged_flash_prefill_fp8kv_window",
           "paged_flash_decode_fp8kv": "paged_flash_decode_fp8kv_window",
           "paged_flash_verify_fp8kv": "paged_flash_verify_fp8kv_window",
           "flash_decode_fp8kv": "flash_decode_fp8kv_window"}
    out = {name: 0 for name in KERNELS}
    for name, n in want.items():
        if not grouped and name.startswith("fused_qkv_append"):
            out[name] += n
        elif name == "fused_qkv_append":
            out["fused_qkv_append_kv_layer"] += n
        elif name == "fused_qkv_append_fp8kv":
            # over e4m3 ring pools: 6e with a kv_layer (6ek)
            out[name] += n
            out["fused_qkv_append_fp8kv_kv_layer"] += n
        elif name == "fused_qkv_append_int8kv":
            # over INT8 ring pools: the quantizing form with a kv_layer
            out[name] += n
            out["fused_qkv_append_int8kv_kv_layer_d256"] += n
        elif name in ren:
            slide = round(n * share)
            out[ren[name]] += slide
            out[name] += n - slide
        else:
            out[name] += n
    return out


def serve_path(torch, path: str, cfg, params, launches: dict, int8: bool,
               kv_dtype: str = "bf16", dev: str = "cuda",
               int4: bool = False) -> float:
    """Drive one weight path of the Engine (bench.py's configuration,
    prefix cache off, KV in ``kv_dtype``): warm-up, the measured run with
    every launch count reset before it and read after it, the decode rate,
    and one graph-replayed decode step beside its bytes floor. A
    sliding-window model runs grouped (its kernels' window forms). Returns
    the decode rate."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.engine import Engine
    from simplellminference_tpu_torch.models import llama

    layers = cfg.num_layers
    batch, prompt_len, new, burst, ps = 8, 128, 32, 16, 128
    cap = prompt_len + new + 2 * burst + ps
    ecfg = EngineConfig(
        max_batch_size=batch,
        kv=KVCacheConfig(page_size=ps, num_pages=batch * (cap // ps + 1) + 8,
                         max_pages_per_seq=cap // ps + 1, kv_dtype=kv_dtype),
        prefix_cache_entries=0)
    rng = np.random.default_rng(0)

    def serve(max_new: int):
        eng = Engine(cfg, params, ecfg, decode_burst=burst, device=dev)
        reqs = [eng.add_request(
            prompt_ids=rng.integers(1, cfg.vocab_size, prompt_len).tolist(),
            sampling=SamplingParams(max_new_tokens=max_new))
            for _ in range(batch)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        return eng, reqs, time.perf_counter() - t

    serve(new)                  # warm-up at the measured length
    reset_counts()
    eng, reqs, wall = serve(new)                      # the measured run
    got = read_counts(path)
    launches[path] = got
    for r in reqs:
        require(r.state.value == "finished" and len(r.output_ids) == new,
                f"[{path}] request {r.req_id}: {r.state} with "
                f"{len(r.output_ids)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in r.output_ids),
                f"[{path}] token id out of range")
    require(eng.metrics.prefills == batch, f"[{path}] {eng.metrics.prefills} "
            f"requests prefilled, expected {batch}")
    admit_ms = max(r.ttft for r in reqs) * 1e3
    steps = eng.metrics.decode_bursts * burst
    want = path_launches(int8, layers,
                         [("flash_prefill", batch * prompt_len)], steps,
                         kv_dtype=kv_dtype, int4=cfg if int4 else None,
                         batch=batch, cfg=cfg)
    if eng._grouped:
        want = windowed(want, cfg)
    want = regime_rows(want, cfg)
    check_launches(path, got, want)
    # decode rate by differencing full and half-length runs (bench.py's
    # method): fresh-engine runs, interleaved, the rate from the medians
    # and its spread from each adjacent (full, half) pair
    walls, halves = [wall], []
    for i in range(RATE_RUNS):
        halves.append(serve(new // 2)[2])
        if i + 1 < RATE_RUNS:
            walls.append(serve(new)[2])
    tokens = batch * (new - new // 2)
    wall_full = statistics.median(walls)
    wall_half = statistics.median(halves)
    require(wall_full > wall_half, f"[{path}] median walls: {new} tokens "
            f"{wall_full} s, {new // 2} tokens {wall_half} s")
    decode_tps = tokens / (wall_full - wall_half)
    pair_tps = [tokens / (f - h) for f, h in zip(walls, halves)]
    print(f"[engine:{path}] {batch} requests x {new} tokens: walls {walls} "
          f"s ({eng.metrics.decode_bursts} bursts x {burst} steps); "
          f"{new // 2}-token walls {halves} s", flush=True)
    print(f"[engine:{path}] decode {decode_tps} tok/s (median-wall "
          f"difference); per pair {pair_tps}", flush=True)
    print(f"[engine:{path}] launches {json.dumps(got)}", flush=True)
    print(f"[engine:{path}] admission: max TTFT of the wave of {batch} x "
          f"{prompt_len}-token prompts {admit_ms:.3f} ms (the measured "
          f"run)", flush=True)

    # One decode step's device time without host gaps: forward_paged at
    # the run's mean context, captured in a CUDA graph and replayed.
    ctx = prompt_len + new // 2 + new // 4
    mp = ecfg.kv.max_pages_per_seq
    tables = torch.arange(batch * mp, dtype=torch.int32,
                          device=dev).reshape(batch, mp)
    tok = torch.ones((batch, 1), dtype=torch.int32, device=dev)
    pos = torch.full((batch, 1), ctx - 1, dtype=torch.int32, device=dev)
    if eng._grouped:
        tables = (tables, eng._ring_table(mp))
    step_ms = time_ms(torch, lambda: llama.forward_paged(
        cfg, params, tok, pos, eng.cache, tables, pos[:, 0] + 1,
        prefill=False), iters=5)
    if path in ("int8", "gemma"):
        # where the INT8 device step's time goes, kernel by kernel
        print_kernel_split(torch, f"[engine:{path}] decode step",
                           lambda: llama.forward_paged(
                               cfg, params, tok, pos, eng.cache, tables,
                               pos[:, 0] + 1, prefill=False), calls=5)
    engine_step_ms = (wall_full - wall_half) * 1e3 / (new - new // 2)
    wbytes = step_weight_bytes(params, batch)
    kvbytes = live_kv_bytes(cfg, batch, ctx, kv_dtype)
    floor_ms = (wbytes + kvbytes) / HBM_BYTES_PER_S * 1e3
    STEPS[path] = (round(engine_step_ms, 3), round(step_ms, 3),
                   round(floor_ms, 3),
                   round(max(0.0, 1 - step_ms / engine_step_ms), 3))
    print(f"[engine:{path}] decode step: engine {engine_step_ms:.3f} ms, "
          f"device (graph replay) {step_ms:.3f} ms, bytes floor "
          f"{floor_ms:.3f} ms ({wbytes / 1e9:.3f} GB weights + "
          f"{kvbytes / 1e9:.3f} GB KV); device idle share of the engine "
          f"step {max(0.0, 1 - step_ms / engine_step_ms):.3f}", flush=True)
    del eng
    return decode_tps


def prefix_waves(rng, vocab: int, system_len: int, suffix_len: int,
                 batch: int) -> list:
    """The server traffic of the `prefix` path: every prompt is one shared
    system prompt plus its own user suffix; waves of 1, batch - 1 and
    batch prompts."""
    system = rng.integers(1, vocab, system_len).tolist()
    return [[system + rng.integers(1, vocab, suffix_len).tolist()
             for _ in range(k)] for k in (1, batch - 1, batch)]


def run_waves(eng, waves, samp) -> list:
    """The first wave; after the engine's first step, the second (its
    requests share the running request's system-prompt pages); after all
    finish, the third (it hits the persistent store). Returns each wave's
    requests."""
    reqs = [[eng.add_request(prompt_ids=p, sampling=samp)
             for p in waves[0]]]
    eng.step()
    for wave in waves[1:]:
        reqs.append([eng.add_request(prompt_ids=p, sampling=samp)
                     for p in wave])
        eng.run()
    return reqs


def prefix_engine_config(batch: int, ps: int, chunk: int, cap: int,
                         kv_dtype: str, **kw):
    """``EngineConfig`` defaults (prefix cache on, 16 entries) but for the
    batch, the chunk, the page size and the KV dtype."""
    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig)
    mp = -(-cap // ps)
    return EngineConfig(max_batch_size=batch, prefill_chunk=chunk,
                        kv=KVCacheConfig(page_size=ps,
                                         num_pages=batch * mp + 16,
                                         max_pages_per_seq=mp,
                                         kv_dtype=kv_dtype), **kw)


def long_context_steps(torch, cfg, params, dev: str = "cuda"):
    """One graph-replayed forward_paged decode step at kv_len 4096, batch 8,
    over bf16 pools, INT8 pools and e4m3 pools (filled from a seed), beside
    each one's bytes floor: the weights plus that KV read once."""
    from simplellminference_tpu_torch.memory.paged_kv import (
        PagedKVCache, kv_storage_dtype)
    from simplellminference_tpu_torch.models import llama
    from simplellminference_tpu_torch.ops.ref_ops import to_e4m3

    batch, kv_len, ps = 8, 4096, 128
    mp = kv_len // ps
    layers, kvn, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    tables = torch.arange(batch * mp, dtype=torch.int32,
                          device=dev).reshape(batch, mp)
    tok = torch.ones((batch, 1), dtype=torch.int32, device=dev)
    pos = torch.full((batch, 1), kv_len - 1, dtype=torch.int32, device=dev)
    out = {}
    for kv_dtype in ("bf16", "int8", "fp8"):
        gen = torch.Generator(device=dev).manual_seed(21)
        cache = PagedKVCache.create(layers, batch * mp, kvn, ps, d,
                                    kv_storage_dtype(kv_dtype), device=dev)
        if kv_dtype == "int8":
            for pool in (cache.k, cache.v):
                pool.random_(-127, 128, generator=gen)
            for sc in (cache.k_scale, cache.v_scale):
                sc.uniform_(1e-3, 2e-2, generator=gen)
        elif kv_dtype == "fp8":
            for pool in (cache.k, cache.v):
                for li in range(layers):       # layer by layer: the cast's
                    pool[li].copy_(to_e4m3(torch.randn(   # f32 temporaries
                        pool.shape[1:], generator=gen, device=dev)))
        else:
            for pool in (cache.k, cache.v):
                pool.normal_(generator=gen)
        torch.cuda.synchronize()
        ms = time_ms(torch, lambda: llama.forward_paged(
            cfg, params, tok, pos, cache, tables, pos[:, 0] + 1,
            prefill=False), iters=5)
        wbytes = step_weight_bytes(params, batch)
        kvb = kv_bytes(layers, batch * kv_len, kvn, d, kv_dtype)
        floor = (wbytes + kvb) / HBM_BYTES_PER_S * 1e3
        out[kv_dtype] = (ms, floor)
        print(f"[engine:int8kv] decode step at kv_len {kv_len}, batch "
              f"{batch}, {kv_dtype} KV: device (graph replay) {ms:.3f} ms, "
              f"bytes floor {floor:.3f} ms ({wbytes / 1e9:.3f} GB weights + "
              f"{kvb / 1e9:.3f} GB KV)", flush=True)
        del cache
        torch.cuda.empty_cache()
    for kv_dtype in ("int8", "fp8"):
        print(f"[engine:int8kv] kv_len {kv_len}: {kv_dtype} KV step / bf16 KV "
              f"step = {out[kv_dtype][0] / out['bf16'][0]:.3f} (floors "
              f"{out[kv_dtype][1] / out['bf16'][1]:.3f})", flush=True)


def serve_prefix(torch, path: str, cfg, params, launches: dict, int8: bool,
                 kv_dtype: str = "bf16", dev: str = "cuda") -> list:
    """The server's default configuration on the card: prefix cache on,
    prefill_chunk 256, page 128, KV in ``kv_dtype``, batch 8. A
    512-token system prompt with 64-token user suffixes: the first
    request prefills as 3 chunks of 256, the 7 admitted after its first
    step share its 512 cached tokens and prefill their suffixes as one
    batch, and the 8 admitted after all finish hit the persistent store
    as one batch. The grouped engine (a sliding-window model with ring
    pools, GPT-OSS) shares no prefix, as in the JAX package (ring pages are
    slot-owned): there every prompt prefills as its own 3 chunks. Launch
    counts are reset before and read after."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import SamplingParams
    from simplellminference_tpu_torch.engine import Engine

    layers = cfg.num_layers
    batch, system_len, suffix, new, burst, ps, chunk = (8, 512, 64, 32, 16,
                                                        128, 256)
    prompt_len = system_len + suffix
    ecfg = prefix_engine_config(batch, ps, chunk,
                                prompt_len + new + 2 * burst + 1, kv_dtype)
    require(ecfg.prefix_cache_entries == 16, "not the default prefix cache")
    waves = prefix_waves(np.random.default_rng(1), cfg.vocab_size,
                         system_len, suffix, batch)
    samp = SamplingParams(max_new_tokens=new)
    eng = Engine(cfg, params, ecfg, decode_burst=burst, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    reqs = run_waves(eng, waves, samp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts(path)
    launches[path] = got
    m = eng.metrics
    for r in sum(reqs, []):
        require(r.state.value == "finished" and len(r.output_ids) == new,
                f"[{path}] request {r.req_id}: {r.state} with "
                f"{len(r.output_ids)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in r.output_ids),
                f"[{path}] token id out of range")
    grouped = eng._grouped
    shared = 0 if grouped else system_len
    require([r.cached_len for w in reqs for r in w]
            == [0] + [shared] * (2 * batch - 1),
            f"[{path}] cached lengths {[r.cached_len for r in sum(reqs, [])]}")
    hits = 0 if grouped else 2 * batch - 1
    require((m.prefix_cache_hits, m.prefix_cache_persistent_hits,
             m.prompt_tokens_cached, m.prefills) == (
                hits, 0 if grouped else batch, hits * system_len,
                2 * batch),
            f"[{path}] prefix metrics {m.summary()}")
    if grouped:
        # every prompt as its own chunks of 256 rows
        dispatches = ([("paged_flash_prefill", chunk)]
                      * (2 * batch * -(-prompt_len // chunk)))
    else:
        # 3 chunks of 256 rows, then two suffix batches of 8 x 64 rows
        dispatches = ([("paged_flash_prefill", chunk)] * 3
                      + [("paged_flash_prefill", batch * suffix)] * 2)
    want = path_launches(int8, layers, dispatches,
                         m.decode_bursts * burst, kv_dtype=kv_dtype,
                         act_quant=cfg.act_quant == "int8", cfg=cfg)
    if grouped:
        want = windowed(want, cfg)
    want = regime_rows(want, cfg)
    check_launches(path, got, want)
    ttft = [r.ttft for r in reqs[2]]
    print(f"[engine:{path}] {2 * batch} requests ({system_len}-token system "
          f"prompt + {suffix}-token suffixes) x {new} tokens in {wall:.3f} s; "
          f"prefix hits {m.prefix_cache_hits} (persistent "
          f"{m.prefix_cache_persistent_hits}), cached prompt tokens "
          f"{m.prompt_tokens_cached}, {m.decode_bursts} bursts x {burst} "
          f"steps", flush=True)
    print(f"[engine:{path}] launches {json.dumps(got)}", flush=True)
    wave_ttft = [max(r.ttft for r in w) * 1e3 for w in reqs]
    if grouped:
        # the cache shares nothing here: no cache-off run to set beside it
        print(f"[engine:{path}] max TTFT of each wave (1, {batch - 1}, "
              f"{batch} requests, every prompt in 3 chunks): {wave_ttft} ms",
              flush=True)
        del eng
        return wave_ttft
    # the last wave's admit (its TTFT: added, then admitted and prefilled
    # in the next step) beside the same 8 prompts with the cache off
    off = Engine(cfg, params, prefix_engine_config(
        batch, ps, chunk, prompt_len + new + 2 * burst + 1, kv_dtype,
        prefix_cache_entries=0), decode_burst=burst, device=dev)
    torch.cuda.synchronize()
    off_reqs = [off.add_request(prompt_ids=p, sampling=samp)
                for p in waves[2]]
    off.run()
    ttft_off = [r.ttft for r in off_reqs]
    same = sum(a.output_ids == b.output_ids
               for a, b in zip(off_reqs, reqs[2]))
    print(f"[engine:{path}] last wave admit (max TTFT of its 8 requests): "
          f"{max(ttft) * 1e3:.3f} ms with the prefix cache (one suffix "
          f"batch), {max(ttft_off) * 1e3:.3f} ms without it (8 x 3 chunks); "
          f"TTFTs {ttft} / {ttft_off} s; bf16 greedy outputs equal in "
          f"{same} of {batch} (card vs CPU in f32: phase 5)", flush=True)
    print(f"[engine:{path}] max TTFT of each wave (1, {batch - 1}, {batch} "
          f"requests): {wave_ttft} ms", flush=True)
    del eng, off
    return wave_ttft


def prefix_decode(torch, path: str, cfg, params, kv_dtype: str,
                  dev: str = "cuda") -> float:
    """The decode rate of the server's default configuration (the prefix
    path's engine: prefix cache on, chunk 256, page 128, burst 16) on the
    prefix traffic once its 512-token system prompt is cached: waves of 8
    requests (64-token suffixes, one suffix batch each) with 32 and 16 new
    tokens, interleaved on one engine, the rate from the median walls'
    difference; then one graph-replayed decode step at the mean context
    beside its bytes floor and the device's idle share of the engine
    step. The grouped engine shares no prefix (each wave prefills its
    prompts whole, in chunks) and replays the step over its ring pools.
    Returns the rate."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import SamplingParams
    from simplellminference_tpu_torch.engine import Engine
    from simplellminference_tpu_torch.models import llama

    batch, system_len, suffix, new, burst, ps, chunk = (8, 512, 64, 32, 16,
                                                        128, 256)
    ecfg = prefix_engine_config(batch, ps, chunk,
                                system_len + suffix + new + 2 * burst + 1,
                                kv_dtype)
    rng = np.random.default_rng(2)
    system = rng.integers(1, cfg.vocab_size, system_len).tolist()
    eng = Engine(cfg, params, ecfg, decode_burst=burst, device=dev)

    def wave(max_new: int) -> float:
        reqs = [eng.add_request(
            prompt_ids=system + rng.integers(1, cfg.vocab_size,
                                             suffix).tolist(),
            sampling=SamplingParams(max_new_tokens=max_new))
            for _ in range(batch)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        require(all(r.state.value == "finished"
                    and len(r.output_ids) == max_new for r in reqs),
                f"[{path}] a request of the rate's waves did not finish")
        return time.perf_counter() - t

    wave(new)                   # the system prompt cached, warm
    walls, halves = [], []
    for _ in range(3):
        walls.append(wave(new))
        halves.append(wave(new // 2))
    require(eng._grouped or eng.metrics.prefix_cache_hits >= 6 * batch,
            f"[{path}] the rate's waves missed the prefix cache")
    wall_full, wall_half = statistics.median(walls), statistics.median(halves)
    tokens = batch * (new - new // 2)
    rate = tokens / (wall_full - wall_half)
    engine_step_ms = (wall_full - wall_half) * 1e3 / (new - new // 2)
    ctx = system_len + suffix + new // 2 + new // 4
    mp = ecfg.kv.max_pages_per_seq
    tables = torch.arange(batch * mp, dtype=torch.int32,
                          device=dev).reshape(batch, mp)
    tok = torch.ones((batch, 1), dtype=torch.int32, device=dev)
    pos = torch.full((batch, 1), ctx - 1, dtype=torch.int32, device=dev)
    if eng._grouped:
        tables = (tables, eng._ring_table(mp))
    step_ms = time_ms(torch, lambda: llama.forward_paged(
        cfg, params, tok, pos, eng.cache, tables, pos[:, 0] + 1,
        prefill=False), iters=5)
    wbytes = step_weight_bytes(params, batch)
    kvbytes = live_kv_bytes(cfg, batch, ctx, kv_dtype)
    floor_ms = (wbytes + kvbytes) / HBM_BYTES_PER_S * 1e3
    cached = ("uncached: the grouped engine shares no prefix"
              if eng._grouped else "cached")
    print(f"[engine:{path}] decode {rate} tok/s with the system prompt "
          f"{cached} (median-wall difference of waves of {batch} x {new} and "
          f"{new // 2} tokens: walls {walls} / {halves} s)", flush=True)
    STEPS[path] = (round(engine_step_ms, 3), round(step_ms, 3),
                   round(floor_ms, 3),
                   round(max(0.0, 1 - step_ms / engine_step_ms), 3))
    print(f"[engine:{path}] decode step: engine {engine_step_ms:.3f} ms, "
          f"device (graph replay) {step_ms:.3f} ms, bytes floor "
          f"{floor_ms:.3f} ms ({wbytes / 1e9:.3f} GB weights + "
          f"{kvbytes / 1e9:.3f} GB KV); device idle share of the engine "
          f"step {max(0.0, 1 - step_ms / engine_step_ms):.3f}", flush=True)
    del eng
    return rate


def spec_launches(int8: bool, layers: int, steps: int,
                  kv_dtype: str = "bf16", dispatches=None) -> dict:
    """Launches of a speculative path's run: one whole-prompt prefill
    dispatch of 8 x 128 rows (:func:`path_launches`; or ``dispatches``,
    those of the prefix traffic), then ``steps``
    verify forwards, each per layer a span write (11, 11e over FP8 KV; an
    eager quantize and indexed write over INT8 KV: no kernel) and a verify
    attention (4v, 4vq, 4ve), with
    INT8 weights at M = 8 x 5 = 40 rows: quantized_matmul for wqkv and wo
    and fused_ffn per layer, plus the LM head, the quantized_matmul calls
    on its tensor-core regime. No single-row decode kernel runs: every
    step is a verify window."""
    want = path_launches(int8, layers,
                         dispatches or [("flash_prefill", 8 * 128)], 0,
                         kv_dtype=kv_dtype)
    kv = {"int8": "_int8kv", "fp8": "_fp8kv"}.get(kv_dtype, "")
    want["paged_flash_verify" + kv] += layers * steps
    if kv_dtype != "int8":
        want["paged_append_span" + kv] += layers * steps
    if int8:
        want["quantized_matmul"] += (2 * layers + 1) * steps
        want["quantized_matmul_mma"] += (2 * layers + 1) * steps
        want["fused_ffn"] += layers * steps
    return want


def spec_prompts(rng, vocab: int, batch: int, prompt_len: int) -> list:
    """The spec paths' traffic: half the prompts repeat a 16-token pattern
    of their own (prompt lookup finds drafts there), half are random."""
    out = []
    for i in range(batch):
        if i % 2 == 0:
            pat = rng.integers(1, vocab, 16).tolist()
            out.append((pat * (prompt_len // 16 + 1))[:prompt_len])
        else:
            out.append(rng.integers(1, vocab, prompt_len).tolist())
    return out


def spec_engine_config(spec: int, kv_dtype: str, batch: int, cap: int):
    """The server CLI's engine configuration (cli/serve.py:23-43,
    :108-118: page 128, 64 pages per sequence, the default prefix cache)
    with ``--spec-tokens`` and ``--kv-dtype``, the pool cut to the pages
    this traffic needs (the CLI's 2048 pages of 7B bf16 KV would take
    137 GB)."""
    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig)
    ps = 128
    return EngineConfig(max_batch_size=batch, spec_tokens=spec,
                        kv=KVCacheConfig(page_size=ps,
                                         num_pages=batch * -(-cap // ps) + 16,
                                         max_pages_per_seq=64,
                                         kv_dtype=kv_dtype))


def serve_spec(torch, path: str, cfg, params, launches: dict, int8: bool,
               kv_dtype: str, dev: str = "cuda", prefix: bool = False):
    """Prompt-lookup speculation (spec_tokens 4, burst 4) serving 8 greedy
    requests of 128-token prompts and 64 new tokens (:func:`spec_prompts`):
    the measured run with the launch counts reset before and read after
    it, the acceptance rate, decode tok/s by differencing 64- and
    32-token runs beside the same engine with spec_tokens=0, and one
    graph-replayed verify step (S = 5) beside one decode step (S = 1) at
    context ~152 (a host read inside a step would break the capture),
    each beside its engine step (the wall difference over the difference
    in steps), the bytes floor (every weight, every folded expert, and
    the live KV) and the device's idle share. With ``prefix``: the
    `prefix` path's traffic instead (:func:`prefix_waves`: a 512-token
    system prompt + 64-token suffixes, waves of 1, 7 and 8 in the
    measured run, the last wave's 8 prompts in the rate's runs) on the
    server's default engine with speculation (prefix cache on, chunks of
    256: the grouped engine shares no prefix and prefills every prompt
    as 3 chunks), the steps at context ~600."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import SamplingParams
    from simplellminference_tpu_torch.engine import Engine
    from simplellminference_tpu_torch.models import llama

    layers, g = cfg.num_layers, 4
    batch, prompt_len, new, burst = 8, 128, 64, 4
    if prefix:
        system_len, suffix, chunk = 512, 64, 256
        prompt_len = system_len + suffix
        waves = prefix_waves(np.random.default_rng(1), cfg.vocab_size,
                             system_len, suffix, batch)
        prompts = waves[2]
    else:
        prompts = spec_prompts(np.random.default_rng(3), cfg.vocab_size,
                               batch, prompt_len)
        waves = [prompts]
    cap = prompt_len + new + 2 * burst * (g + 1) + 1

    def config(spec: int):
        if prefix:
            return prefix_engine_config(batch, 128, chunk, cap, kv_dtype,
                                        spec_tokens=spec)
        return spec_engine_config(spec, kv_dtype, batch, cap)

    def serve(spec: int, max_new: int, traffic=None):
        eng = Engine(cfg, params, config(spec), decode_burst=burst,
                     device=dev)
        samp = SamplingParams(max_new_tokens=max_new)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if traffic is None:
            reqs = [eng.add_request(prompt_ids=p, sampling=samp)
                    for p in prompts]
            eng.run()
        else:
            reqs = sum(run_waves(eng, traffic, samp), [])
        torch.cuda.synchronize()
        return eng, reqs, time.perf_counter() - t

    measured = waves if prefix else None
    serve(g, new)                       # warm-up at the measured length
    reset_counts()
    eng, reqs, wall = serve(g, new, measured)     # the measured run
    got = read_counts(path)
    launches[path] = got
    m = eng.metrics
    for r in reqs:
        require(r.state.value == "finished" and len(r.output_ids) == new,
                f"[{path}] request {r.req_id}: {r.state} with "
                f"{len(r.output_ids)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in r.output_ids),
                f"[{path}] token id out of range")
    require(m.prefills == len(reqs) and m.spec_steps > 0,
            f"[{path}] metrics {m.summary()}")
    dispatches = None
    if prefix:
        require(eng._grouped and m.prefix_cache_hits == 0,
                f"[{path}] the prefix traffic's launch counts are those of "
                f"the grouped engine (no shared prefix): {m.summary()}")
        dispatches = ([("paged_flash_prefill", chunk)]
                      * (len(reqs) * -(-prompt_len // chunk)))
    want = spec_launches(int8, layers, m.decode_bursts * burst, kv_dtype,
                         dispatches)
    if eng._grouped:
        want = windowed(want, cfg)
    want = regime_rows(want, cfg)
    check_launches(path, got, want)
    accept = m.spec_accepted / m.spec_steps / g
    outs = [r.output_ids for r in reqs]
    plain_eng, plain_reqs, plain_wall = serve(0, new, measured)
    same = sum(a == r.output_ids for a, r in zip(outs, plain_reqs))
    print(f"[engine:{path}] {len(reqs)} requests x {new} tokens, "
          f"spec_tokens {g}, burst {burst}: wall {wall:.3f} s, "
          f"{m.decode_bursts} bursts x "
          f"{burst} verify steps; spec_steps {m.spec_steps}, spec_accepted "
          f"{m.spec_accepted}: acceptance {accept} of the drafts; spec_tokens"
          f"=0 wall {plain_wall:.3f} s ({plain_eng.metrics.decode_bursts} "
          f"bursts); greedy outputs equal to spec_tokens=0 in {same} of "
          f"{len(reqs)} (card vs CPU in f32: phase 5)", flush=True)
    print(f"[engine:{path}] launches {json.dumps(got)}", flush=True)
    # decode rate by differencing 64- and 32-token runs, interleaved, for
    # the spec engine and the same engine with spec_tokens=0
    rates, step_walls = {}, {}
    for spec in (g, 0):
        walls, halves, bursts = [], [], []
        for _ in range(SPEC_RATE_RUNS):
            for n_new, into in ((new, walls), (new // 2, halves)):
                e_, _r, w_ = serve(spec, n_new)
                into.append(w_)
                bursts.append(e_.metrics.decode_bursts)
                del e_
        wf, wh = statistics.median(walls), statistics.median(halves)
        require(wf > wh, f"[{path}] spec_tokens={spec} median walls: {new} "
                f"tokens {wf} s, {new // 2} tokens {wh} s")
        rates[spec] = batch * (new - new // 2) / (wf - wh)
        # the engine's step: the wall difference over the difference in
        # steps (bursts of `burst` verify or decode steps)
        steps = (statistics.median(bursts[0::2])
                 - statistics.median(bursts[1::2])) * burst
        step_walls[spec] = (wf - wh) * 1e3 / max(steps, 1)
        print(f"[engine:{path}] spec_tokens={spec}: decode {rates[spec]} "
              f"tok/s (median-wall difference); walls {walls} / {halves} s",
              flush=True)
    print(f"[engine:{path}] decode tok/s with speculation / without: "
          f"{rates[g] / rates[0]:.3f}", flush=True)
    # one verify step (S = 5) and one decode step (S = 1), graph-replayed,
    # at context ~152 (~600 with the prefix traffic) over the run's cache
    ctx = prompt_len + 24
    mp = max(4, -(-(ctx + g + 1) // 128))
    tables = torch.arange(batch * mp, dtype=torch.int32,
                          device=dev).reshape(batch, mp)
    if eng._grouped:
        tables = (tables, eng._ring_table(mp))
    times = {}
    for s in (g + 1, 1):
        tok = torch.ones((batch, s), dtype=torch.int32, device=dev)
        pos = (ctx - 1 + torch.arange(s, dtype=torch.int32, device=dev)
               )[None].expand(batch, s).contiguous()
        kv = pos[:, 0] + s
        times[s] = time_ms(torch, lambda: llama.forward_paged(
            cfg, params, tok, pos, eng.cache, tables, kv, prefill=False),
            iters=5)
    print(f"[engine:{path}] device step (graph replay) at context {ctx}: "
          f"verify (S={g + 1}) {times[g + 1]:.3f} ms, decode (S=1) "
          f"{times[1]:.3f} ms, ratio {times[g + 1] / times[1]:.3f}; both "
          f"captured in a CUDA graph (no host read inside a step)",
          flush=True)
    wbytes = step_weight_bytes(params, batch)
    kvbytes = live_kv_bytes(cfg, batch, ctx, kv_dtype)
    floor_ms = (wbytes + kvbytes) / HBM_BYTES_PER_S * 1e3
    STEPS[path] = (round(step_walls[g], 3), round(times[g + 1], 3),
                   round(floor_ms, 3),
                   round(max(0.0, 1 - times[g + 1] / step_walls[g]), 3))
    for spec, s in ((g, g + 1), (0, 1)):
        print(f"[engine:{path}] spec_tokens={spec} step: engine "
              f"{step_walls[spec]:.3f} ms, device (graph replay, S={s}) "
              f"{times[s]:.3f} ms, bytes floor {floor_ms:.3f} ms "
              f"({wbytes / 1e9:.3f} GB weights + {kvbytes / 1e9:.3f} GB "
              f"KV); device idle share of the engine step "
              f"{max(0.0, 1 - times[s] / step_walls[spec]):.3f}",
              flush=True)
    del eng, plain_eng


def dense_launches(int8: bool, layers: int, steps: int,
                   int4=None, cfg=None, kv_dtype: str = "bf16") -> dict:
    """Launches of one ``generate_fused`` call of the dense paths: the
    8 x 128-row prefill (per layer ``kv_append`` at S = 128 and causal
    ``flash_prefill``; with INT8 weights 4 ``quantized_matmul`` per layer
    at m = 1024 rows, its tensor-core regime, plus the LM head on the 8
    last rows), then ``steps``
    decode steps, each per layer ``flash_decode`` and, with INT8 weights,
    the dense fused qkv, ``wo`` and ``fused_ffn`` plus the LM head, with
    bf16 weights ``kv_append`` at S = 1 (the products are cuBLAS). With
    ``int4`` (the model config of INT4 weights) every product of the
    prefill and of each step (4 a layer and the head) is an INT4 kernel
    launch, each also in its tensor-core regime's row (the prefill's 1024
    rows, the head and every step at 8), K/V written as with bf16. ``cfg``
    (the model's config, when not Llama's): a tied head (Gemma) is a bf16
    torch.matmul, no launch; a GeGLU FFN takes no fused_ffn but two
    quantized_matmul a layer; a mixture of experts (GPT-OSS) takes no
    fused FFN: each decode step runs the folded experts' two products on
    kernel 5, the prefill the grouped experts (dequantized,
    ``torch.matmul``), so the prefill launches kernel 5 for wqkv and wo
    only; a QKV bias (GPT-OSS) takes the qkv product and ``kv_append``
    instead of the fused qkv at decode. ``kv_dtype`` "fp8" (an e4m3
    arena): each write and read takes its FP8-KV form, ``kv_append_fp8kv``
    (12e), ``flash_decode_fp8kv`` (13e) and the dense fused qkv's
    ``fused_qkv_append_fp8kv`` with ``tables=None`` (6de, also in
    ``fused_qkv_append_fp8kv_dense``); the prefill's attention on the
    fresh rows is unchanged."""
    head = int(cfg is None or not cfg.tie_word_embeddings)
    moe = cfg is not None and bool(cfg.num_experts)
    # the fused FFN's gate, and the fused qkv's (no QKV bias)
    glu = (cfg is None or cfg.hidden_act == "silu") and not moe
    fqkv = cfg is None or not cfg.attention_bias
    want = {name: 0 for name in KERNELS}
    want["kv_append"] += layers
    want["flash_prefill"] += layers
    want["flash_decode"] += layers * steps
    if int4:
        want["quantized_matmul_int4"] += (4 * layers + 1) * (1 + steps)
        for m, times in ((1024, 1), (8, steps)):
            for name, c in int4_regime_counts(int4, m, 8, layers).items():
                want[name] += c * times
        want["kv_append"] += layers * steps
    elif int8:
        per = 2 if moe else 4      # MoE: the prefill's experts off kernel 5
        want["quantized_matmul"] += per * layers + head + (
            layers * ((1 if glu else 3) + (not fqkv)) + head) * steps
        want["quantized_matmul_mma"] += per * layers
        want["fused_qkv_append_dense"] += layers * steps * fqkv
        want["fused_ffn"] += layers * steps * glu
        want["kv_append"] += layers * steps * (not fqkv)
    else:
        want["kv_append"] += layers * steps
    if kv_dtype == "fp8":
        for name in ("kv_append", "flash_decode"):
            want[name + "_fp8kv"], want[name] = want[name], 0
        n = want["fused_qkv_append_dense"]
        want["fused_qkv_append_dense"] = 0
        want["fused_qkv_append_fp8kv"] += n
        want["fused_qkv_append_fp8kv_dense"] += n
    return want


def serve_dense(torch, path: str, cfg, params, launches: dict, int8: bool,
                dev: str = "cuda", int4: bool = False, batch: int = 8,
                prompt_len: int = 128, max_seq: int = 1024,
                kv_dtype: str = "bf16"):
    """bench.py's Generator (bench.py:208-239): bf16 KV (or, ``kv_dtype``
    "fp8", an e4m3 arena: bench.py --kv-dtype fp8), ``generate_fused``
    on ``batch`` fresh ``prompt_len``-token prompts (max_seq 1024, 8 x 128
    at bench.py's shape). The launch counts of one 64-token call (reset
    before, read after); the same call of the device part under
    ``torch.cuda.set_sync_debug_mode("error")`` (any host sync inside it
    raises); ``fused_decode_toks_s`` by bench.py's differencing (the
    fastest of three 64- and of three 32-token calls); one graph-replayed
    decode step beside its bytes floor. A sliding-window model's layers
    take the window forms (3w, 13w) and their bytes floor reads at most
    the window's keys. A mixture of experts (gpt-oss) holds its decode
    steps alone to the sync debug mode: its grouped prefill reads the
    group sizes on the host once a layer (ops/moe.py). The decode step's
    (loop, device, floor ms; idle share) go to ``STEPS[path]``."""
    import numpy as np

    from simplellminference_tpu_torch.ops import sampling
    from simplellminference_tpu_torch.runtime.generator import Generator

    steps = 64
    half = steps // 2
    gen = Generator(cfg, params, max_batch=batch, max_seq=max_seq,
                    kv_dtype={"bf16": torch.bfloat16,
                              "fp8": torch.float8_e4m3fn}[kv_dtype],
                    device=dev)
    rng = np.random.default_rng(0)

    def prompts():
        return [rng.integers(1, cfg.vocab_size, prompt_len).tolist()
                for _ in range(batch)]

    def timed(n: int) -> float:
        p = prompts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = gen.generate_fused(p, max_new_tokens=n).cpu()
        wall = time.perf_counter() - t
        require(tuple(out.shape) == (batch, n) and bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()),
            f"[{path}] generate_fused gave {tuple(out.shape)} / ids out of "
            f"range")
        return wall

    timed(half)
    timed(steps)                        # warm-up at both lengths
    reset_counts()
    timed(steps)
    got = read_counts(path)
    launches[path] = got
    want = dense_launches(int8, cfg.num_layers, steps,
                          int4=cfg if int4 else None, cfg=cfg,
                          kv_dtype=kv_dtype)
    if any(w is not None for w in cfg.layer_windows):
        want = windowed(want, cfg, grouped=False)
    want = regime_rows(want, cfg)
    check_launches(path, got, want)
    tokens, lens = gen._bucket(prompts())
    tokens, lens = gen._tensor(tokens), gen._tensor(lens)
    first = None
    if cfg.num_experts:
        cache = gen.new_cache(batch, tokens.shape[1] + steps)
        logits, cache = gen._prefill_fn(tokens, cache, lens)
        first = sampling.greedy(logits)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = (gen._fused_generate(tokens, lens, steps) if first is None
               else gen._decode_steps(first, lens, cache, steps))
    except RuntimeError as e:
        raise SmokeFailure(f"[{path}] a host sync inside the fused loop: "
                           f"{e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    require(tuple(out.shape) == (batch, steps), f"[{path}] fused loop")
    t_full = min(timed(steps) for _ in range(3))
    t_half = min(timed(half) for _ in range(3))
    require(t_full > t_half, f"[{path}] {steps} tokens {t_full} s, {half} "
            f"tokens {t_half} s")
    toks_s = batch * (steps - half) / (t_full - t_half)
    step_wall = (t_full - t_half) * 1e3 / (steps - half)
    print(f"[engine:{path}] Generator.generate_fused, batch {batch} x "
          f"{prompt_len}-token prompts: fused_decode_toks_s {toks_s} "
          f"(fastest of three {steps}-token calls {t_full} s, of three "
          f"{half}-token calls {t_half} s); no host sync inside the "
          f"{'decode ' if first is not None else ''}loop (sync debug mode "
          f"'error')", flush=True)
    print(f"[engine:{path}] launches {json.dumps(got)}", flush=True)
    # one decode step, graph-replayed, at the differenced segment's mean
    # context (bench.py's roofline: prompt + 3/4 of the steps)
    ctx = prompt_len + steps * 3 // 4
    cache = gen.new_cache(batch, prompt_len + steps)
    tok = torch.ones(batch, dtype=torch.int32, device=dev)
    pos = torch.full((batch,), ctx - 1, dtype=torch.int32, device=dev)
    step_ms = time_ms(torch, lambda: gen._decode_fn(tok, pos, cache),
                      iters=5)
    wbytes = step_weight_bytes(params, batch)
    kvb = kv_bytes(1, batch * sum(min(ctx, w or ctx)
                                  for w in cfg.layer_windows),
                   cfg.num_kv_heads, cfg.head_dim, kv_dtype)
    floor_ms = (wbytes + kvb) / HBM_BYTES_PER_S * 1e3
    idle = max(0.0, 1 - step_ms / step_wall)
    STEPS[path] = (round(step_wall, 3), round(step_ms, 3),
                   round(floor_ms, 3), round(idle, 3))
    print(f"[engine:{path}] decode step at context {ctx}: loop "
          f"{step_wall:.3f} ms, device "
          f"(graph replay) {step_ms:.3f} ms, bytes floor {floor_ms:.3f} ms "
          f"({wbytes / 1e9:.3f} GB weights + {kvb / 1e9:.3f} GB "
          f"{kv_dtype} KV); device idle share of the loop step "
          f"{idle:.3f}", flush=True)
    del gen, cache


def serve_draft(torch, path: str, cfg, params, launches: dict,
                dev: str = "cuda", draft_cfg=None, draft_name=None):
    """Draft-model speculation (``Engine(draft=...)``): the target ``cfg``
    (Llama-2-7B; Gemma-2-9B) with bf16 weights and KV (the `spec` path's
    engine: the server CLI's configuration with --spec-tokens 4, burst 4;
    a sliding-window target runs grouped) drafted by ``draft_cfg`` (default
    TinyLlama-1.1B) at full width and depth (bf16, random weights from a
    seed), the `spec` traffic (8 greedy requests of 128-token prompts, 64
    new tokens). The measured run's launch counts (reset before, read
    after), TinyLlama's draft arena against the shape phase 3 checks the
    kernels at, the acceptance, decode tok/s with and without the draft
    (spec_tokens 0) by differencing the measured 64-token run and the
    64-token run without the draft against one 32-token run each, and one
    graph-replayed draft rollout (G + 1 steps over B + 1 rows) beside one
    verify step."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import (ModelConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.engine import Engine
    from simplellminference_tpu_torch.models import llama

    layers, g = cfg.num_layers, DRAFT_TOKENS
    batch, prompt_len, new, burst = 8, 128, 64, 4
    dcfg = draft_cfg or ModelConfig.tinyllama_1_1b(num_layers=DRAFT_LAYERS,
                                                   dtype="bfloat16")
    draft_name = draft_name or "TinyLlama-1.1B"
    require(dcfg.vocab_size == cfg.vocab_size, "draft vocab")
    dparams = llama.init_params(dcfg, seed=1, device=dev)
    prompts = spec_prompts(np.random.default_rng(3), cfg.vocab_size, batch,
                           prompt_len)
    cap = prompt_len + new + 2 * burst * (g + 1) + 1

    def serve(spec: int, max_new: int):
        eng = Engine(cfg, params, spec_engine_config(spec, "bf16", batch,
                                                     cap),
                     decode_burst=burst, device=dev,
                     draft=(dcfg, dparams) if spec else None)
        reqs = [eng.add_request(prompt_ids=p, sampling=SamplingParams(
            max_new_tokens=max_new)) for p in prompts]
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        return eng, reqs, time.perf_counter() - t

    serve(g, new // 2)                  # warm-up
    reset_counts()
    eng, reqs, wall = serve(g, new)     # the measured run
    got = read_counts(path)
    launches[path] = got
    m = eng.metrics
    for r in reqs:
        require(r.state.value == "finished" and len(r.output_ids) == new,
                f"[{path}] request {r.req_id}: {r.state} with "
                f"{len(r.output_ids)} tokens")
    require(m.prefills == batch and m.spec_steps > 0,
            f"[{path}] metrics {m.summary()}")
    if draft_cfg is None:
        dl, dslots = draft_arena_shape()
        arena = (dl, batch + 1, dcfg.num_kv_heads, dslots, dcfg.head_dim)
        require(tuple(eng._dcache.k.shape) == arena,
                f"[{path}] draft arena {tuple(eng._dcache.k.shape)}, phase "
                f"3 checks {arena}")
    steps = m.decode_bursts * burst
    dl = dcfg.num_layers
    want = spec_launches(False, layers, steps)
    # the draft: one prefill dispatch of the 8 admits (kv_append at S =
    # 128, flash_prefill), then G + 1 rollout steps per verify step
    dwant = {name: 0 for name in KERNELS}
    dwant["kv_append"] += dl + (g + 1) * dl * steps
    dwant["flash_prefill"] += dl
    dwant["flash_decode"] += (g + 1) * dl * steps
    # each model's sliding layers take the window forms
    if eng._grouped:
        want = windowed(want, cfg)
    if any(w is not None for w in dcfg.layer_windows):
        dwant = windowed(dwant, dcfg)
    want = regime_rows({k: n + dwant[k] for k, n in want.items()}, cfg)
    check_launches(path, got, want)
    accept = m.spec_accepted / m.spec_steps / g
    outs = [r.output_ids for r in reqs]
    plain_eng, plain_reqs, plain_wall = serve(0, new)
    same = sum(a == r.output_ids for a, r in zip(outs, plain_reqs))
    print(f"[engine:{path}] {batch} requests x {new} tokens, spec_tokens {g}"
          f" drafted by {draft_name} ({dl} layers, bf16, random weights), "
          f"burst {burst}: wall {wall:.3f} s, {m.decode_bursts} bursts; "
          f"spec_steps {m.spec_steps}, spec_accepted {m.spec_accepted}: "
          f"acceptance {accept} of the drafts (random weights); "
          f"spec_tokens=0 wall "
          f"{plain_wall:.3f} s; greedy outputs equal to spec_tokens=0 in "
          f"{same} of {batch}", flush=True)
    print(f"[engine:{path}] launches {json.dumps(got)}", flush=True)
    # the rate from the medians of interleaved full- and half-length runs
    # (one host stall in a single half-length run once made it as slow as
    # the full one: 0.739 s both, NVIDIA H100 80GB HBM3, 700.00 W)
    rates = {}
    for spec, first in ((g, wall), (0, plain_wall)):
        walls, halves = [first], []
        for i in range(DRAFT_RATE_RUNS):
            halves.append(serve(spec, new // 2)[2])
            if i + 1 < DRAFT_RATE_RUNS:
                walls.append(serve(spec, new)[2])
        wf, wh = statistics.median(walls), statistics.median(halves)
        require(wf > wh, f"[{path}] spec_tokens={spec} median walls: {new} "
                f"tokens {wf} s, {new // 2} tokens {wh} s")
        rates[spec] = batch * (new - new // 2) / (wf - wh)
        print(f"[engine:{path}] {'draft' if spec else 'no draft'}: decode "
              f"{rates[spec]} tok/s (median-wall difference); walls {walls} "
              f"/ {halves} s", flush=True)
    print(f"[engine:{path}] decode tok/s with the draft / without: "
          f"{rates[g] / rates[0]:.3f}", flush=True)
    # one draft rollout and one verify step, graph-replayed, context ~152
    ctx = prompt_len + 24
    tok = torch.ones(batch, dtype=torch.int32, device=dev)
    pos = torch.full((batch,), ctx - 1, dtype=torch.int32, device=dev)
    roll_ms = time_ms(torch, lambda: eng._model_draft(tok, pos), iters=5)
    mp = 4
    tables = torch.arange(batch * mp, dtype=torch.int32,
                          device=dev).reshape(batch, mp)
    if eng._grouped:
        tables = (tables, eng._ring_table(mp))
    vtok = torch.ones((batch, g + 1), dtype=torch.int32, device=dev)
    vpos = (pos[:, None] + torch.arange(g + 1, dtype=torch.int32,
                                        device=dev)[None]).contiguous()
    verify_ms = time_ms(torch, lambda: llama.forward_paged(
        cfg, params, vtok, vpos, eng.cache, tables, pos + g + 1,
        prefill=False), iters=5)
    print(f"[engine:{path}] device time (graph replay) at context {ctx}: "
          f"draft rollout ({g + 1} steps x {batch + 1} rows) {roll_ms:.3f} "
          f"ms, verify step (S={g + 1}) {verify_ms:.3f} ms", flush=True)
    del eng, plain_eng, dparams


def serve_mistral_window(torch, path: str, cfg, params, launches: dict,
                         dev: str = "cuda", int8: bool = True):
    """Sliding-window attention through the Engine at the width of ``cfg``
    (Mistral-7B: every layer on the ring pools; Gemma-2-2B: the sliding
    half on the ring pools, the full half on the main pools), the grouped
    engine's ring of R = 35 pages of 128 tokens a slot at window 4096 and
    chunk 256: 4 greedy requests of 4224 random tokens, chunked prefill of
    256 rows (the prompt crosses the window), 320 new tokens in bursts of
    16, so decode reaches kv_len 4544 past the ring's 35 x 128 = 4480
    tokens and the ring wraps. Exact launch counts with the counts reset
    around the run; the ring, its pool bytes and the highest kv_len
    reached; the decode's own rate, engine step, graph-replayed device
    step beside its bytes floor, and idle share."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.engine import Engine
    from simplellminference_tpu_torch.models import llama

    batch, prompt_len, new, burst, ps = 4, 4224, 320, 16, 128
    cap = prompt_len + new + 2 * burst + ps
    mp = -(-cap // ps)
    ecfg = EngineConfig(
        max_batch_size=batch, prefill_chunk=MISTRAL_CHUNK,
        kv=KVCacheConfig(page_size=ps, num_pages=batch * mp + 8,
                         max_pages_per_seq=mp, kv_dtype="bf16"))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist()
               for _ in range(batch)]
    eng = Engine(cfg, params, ecfg, decode_burst=burst, device=dev)
    n_w = sum(w is not None for w in cfg.layer_windows)
    require(eng._grouped and eng._ring == MISTRAL_RING
            and eng.cache.k.shape[0] == cfg.num_layers - n_w
            and eng.cache.k_w.shape[0] == n_w,
            f"[{path}] grouped {eng._grouped}, ring {eng._ring}, pools "
            f"{tuple(eng.cache.k.shape)} / {tuple(eng.cache.k_w.shape)}")
    ring_bytes = 2 * eng.cache.k_w.numel() * eng.cache.k_w.element_size()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.add_request(prompt_ids=p, sampling=SamplingParams(
        max_new_tokens=new)) for p in prompts]
    # eng.run(), stepped here to clock the decode apart from admission:
    # (prefills before, bursts dispatched before, time after) per step
    marks = []
    while eng.has_work:
        before = (eng.metrics.prefills, eng.metrics.decode_bursts)
        eng.step()
        marks.append((*before, time.perf_counter()))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    wall = t_end - t0
    got = read_counts(path)
    for r in reqs:
        require(r.state.value == "finished" and len(r.output_ids) == new
                and all(0 <= t < cfg.vocab_size for t in r.output_ids),
                f"[{path}] request {r.req_id}: {r.state} with "
                f"{len(r.output_ids)} tokens")
    steps = eng.metrics.decode_bursts * burst
    top_kv = prompt_len + steps
    require(top_kv > eng._ring * ps, f"[{path}] kv_len reached {top_kv}, "
            f"not past the ring's {eng._ring * ps} tokens")
    chunks = -(-prompt_len // MISTRAL_CHUNK)
    want = windowed(path_launches(
        int8, cfg.num_layers,
        [("paged_flash_prefill", MISTRAL_CHUNK)] * (batch * chunks), steps,
        cfg=cfg), cfg)
    want = regime_rows(want, cfg)
    check_launches(path, got, want)
    print(f"[engine:{path}] {_width(cfg)} ({cfg.num_layers} layers, "
          f"{n_w} of them sliding, window {WINDOW}): {batch} requests x "
          f"{prompt_len} prompt tokens ({chunks} chunks of {MISTRAL_CHUNK} "
          f"each) + {new} tokens in {wall:.2f} s; ring R = {eng._ring} pages "
          f"of {ps} ({eng._ring * ps} tokens) a slot, ring pools "
          f"{ring_bytes / 1e9:.3f} GB for {batch} slots (the full group: "
          f"{cfg.num_layers - n_w} layers); highest kv_len reached {top_kv} "
          f"> {eng._ring * ps}: the ring wrapped", flush=True)
    print(f"[engine:{path}] launches {json.dumps(got)}", flush=True)

    # The decode alone: from the end of the first step that began with
    # every prompt prefilled (it synced the burst before its own, so the
    # bursts from its own on run after the clock starts) to the last
    # burst's end; beside it one graph-replayed decode step at the mean
    # kv_len of those bursts over the engine's ring pools.
    first = next(i for i, (pf, _b, _t) in enumerate(marks) if pf == batch)
    _pf, k0, t_dec = marks[first]
    dec_steps = (eng.metrics.decode_bursts - k0) * burst
    require(dec_steps > 0, f"[{path}] no decode burst after admission")
    engine_step_ms = (t_end - t_dec) * 1e3 / dec_steps
    ctx = prompt_len + burst * (k0 + eng.metrics.decode_bursts) // 2
    tables = torch.arange(batch * mp, dtype=torch.int32,
                          device=dev).reshape(batch, mp)
    tok = torch.ones((batch, 1), dtype=torch.int32, device=dev)
    pos = torch.full((batch, 1), ctx - 1, dtype=torch.int32, device=dev)
    tables = (tables, eng._ring_table(mp))
    step_ms = time_ms(torch, lambda: llama.forward_paged(
        cfg, params, tok, pos, eng.cache, tables, pos[:, 0] + 1,
        prefill=False), iters=5)
    idle = max(0.0, 1 - step_ms / engine_step_ms)
    # bytes floor: the weights, the batch's embedding rows and the live KV
    # (a sliding layer's window, a full layer's whole context)
    wbytes = step_weight_bytes(params, batch)
    kvbytes = (kv_bytes(n_w, batch * min(ctx, WINDOW), cfg.num_kv_heads,
                        cfg.head_dim, "bf16")
               + kv_bytes(cfg.num_layers - n_w, batch * ctx,
                          cfg.num_kv_heads, cfg.head_dim, "bf16"))
    floor_ms = (wbytes + kvbytes) / HBM_BYTES_PER_S * 1e3
    print(f"[engine:{path}] long-run decode: {dec_steps} steps of {batch} "
          f"rows at kv_len {prompt_len + burst * k0}-{top_kv} in "
          f"{t_end - t_dec:.3f} s: {batch * dec_steps / (t_end - t_dec)} "
          f"tok/s, engine step {engine_step_ms:.3f} ms; device step "
          f"(graph replay at kv_len {ctx}) {step_ms:.3f} ms, bytes floor "
          f"{floor_ms:.3f} ms ({wbytes / 1e9:.3f} GB weights + "
          f"{kvbytes / 1e9:.3f} GB KV); device idle share of the engine "
          f"step {idle:.3f}", flush=True)
    del eng
    return got


# path: (weights, KV dtype, prefix-cache traffic)
def mla_launches(absorbed: bool, layers: int, chunks: int,
                 steps: int) -> dict:
    """Launches each kernel must show in one Engine run of an `mla` path
    (bf16 weights and KV, no fused route): per layer, each of ``chunks``
    prefill chunks writes its pages and attends through the tables, each
    of ``steps`` decode steps writes its row and attends. Absorbed: the
    shared-KV forms 2l, 8l, 1l, 4l at D 640 and no launch of a two-pool
    form; naive: 2, 8 and 4 at D 256 (each also in its ``_d256`` row), 1."""
    want = {name: 0 for name in KERNELS}
    if absorbed:
        forms = {"paged_append_prefill_shared": chunks,
                 "paged_flash_prefill_shared": chunks,
                 "paged_append_decode_shared": steps,
                 "paged_flash_decode_shared": steps}
    else:
        forms = {"paged_append_prefill": chunks,
                 "paged_flash_prefill": chunks,
                 "paged_flash_prefill_d256": chunks,
                 "paged_append_decode": steps,
                 "paged_flash_decode": steps,
                 "paged_flash_decode_d256": steps}
    for name, n in forms.items():
        want[name] = n * layers
    return want


def mla_kv_bytes_per_token(cfg) -> int:
    """KV bytes a token keeps in one layer: one latent row (absorbed: a
    shared pool, K is V) or K and V of every head (naive), bf16."""
    rows = 1 if cfg.mla_absorbed else 2
    return rows * cfg.num_kv_heads * cfg.head_dim * 2


def serve_mla(torch, path: str, cfg, params, launches: dict) -> float:
    """bench_mla.py's ``run()`` on the port (benchmarks/bench_mla.py:32-64):
    the Engine's defaults (prefix cache on), prefill_chunk 512, pages of
    128, bf16 KV, decode bursts of 16, 8 random 1024-token prompts and 128
    new tokens each (ignore_eos), absorbed (`mla`) or naive (`mla_naive`).
    A warm-up run, then the measured run with every count reset before it
    and read after it, held to :func:`mla_launches` (every prompt prefills
    as two chunks, at offsets 0 and 512); its decode rate as bench_mla.py
    takes it (tokens after each request's first 8, over the rest of the
    run); one graph-replayed decode step at the run's mean context beside
    its bytes floor (weights + the live latent or K/V rows). Returns the
    decode rate."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.engine import Engine
    from simplellminference_tpu_torch.models import llama

    batch, ctx, steps, chunk, ps, burst = 8, 1024, 128, 512, 128, 16
    ecfg = EngineConfig(
        max_batch_size=batch, prefill_chunk=chunk,
        kv=KVCacheConfig(page_size=ps,
                         num_pages=batch * (ctx + steps + 512) // ps + 8,
                         max_pages_per_seq=(ctx + steps + 512) // ps + 2,
                         kv_dtype="bf16"))

    def serve():
        eng = Engine(cfg, params, ecfg, decode_burst=burst)
        require((eng.cache.v is None) == cfg.mla_absorbed,
                f"[{path}] cache.v is None: {eng.cache.v is None}")
        rng = np.random.default_rng(1)
        samp = SamplingParams(max_new_tokens=steps, ignore_eos=True)
        reqs = [eng.add_request(prompt_ids=rng.integers(1, 8000,
                                                        ctx).tolist(),
                                sampling=samp) for _ in range(batch)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while any(r.num_generated < 8 for r in reqs
                  if r.state.value != "failed"):
            eng.step()
        torch.cuda.synchronize()
        n0 = sum(r.num_generated for r in reqs)
        t1 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tps = (sum(r.num_generated for r in reqs) - n0) / (t2 - t1)
        return eng, reqs, tps, t2 - t0

    serve()                                           # warm-up
    reset_counts()
    eng, reqs, tps, wall = serve()                    # the measured run
    got = read_counts(path)
    launches[path] = got
    for r in reqs:
        require(r.state.value == "finished" and len(r.output_ids) == steps,
                f"[{path}] request {r.req_id}: {r.state} with "
                f"{len(r.output_ids)} tokens")
        require(all(0 <= t < cfg.vocab_size for t in r.output_ids),
                f"[{path}] token id out of range")
    n_steps = eng.metrics.decode_bursts * burst
    check_launches(path, got, mla_launches(
        cfg.mla_absorbed, cfg.num_layers, batch * (ctx // chunk), n_steps))
    print(f"[engine:{path}] {batch} requests x {ctx}-token prompts x "
          f"{steps} tokens in {wall:.3f} s ({eng.metrics.decode_bursts} "
          f"bursts x {burst} steps, {batch * (ctx // chunk)} prefill "
          f"chunks); decode {tps} tok/s (bench_mla.py's rate: the tokens "
          f"after each request's first 8)", flush=True)
    print(f"[engine:{path}] launches {json.dumps(got)}", flush=True)

    # one decode step's device time: forward_paged at the run's mean
    # context, captured in a CUDA graph and replayed
    mean = ctx + steps // 2
    need = -(-(mean + 1) // ps)
    mp = ecfg.kv.max_pages_per_seq
    tables = torch.full((batch, mp), -1, dtype=torch.int32, device="cuda")
    tables[:, :need] = torch.arange(batch * need, dtype=torch.int32,
                                    device="cuda").reshape(batch, need)
    tok = torch.ones((batch, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((batch, 1), mean, dtype=torch.int32, device="cuda")
    step_ms = time_ms(torch, lambda: llama.forward_paged(
        cfg, params, tok, pos, eng.cache, tables, pos[:, 0] + 1,
        prefill=False), iters=5)
    engine_step_ms = 1e3 / (tps / batch)
    wbytes = step_weight_bytes(params, batch)
    per_token = mla_kv_bytes_per_token(cfg)
    kvbytes = cfg.num_layers * batch * (mean + 1) * per_token
    floor_ms = (wbytes + kvbytes) / HBM_BYTES_PER_S * 1e3
    idle = max(0.0, 1 - step_ms / engine_step_ms)
    STEPS[path] = (round(engine_step_ms, 3), round(step_ms, 3),
                   round(floor_ms, 3), round(idle, 3))
    print(f"[engine:{path}] KV bytes per token and layer {per_token} "
          f"({'one shared latent row of' if cfg.mla_absorbed else 'K and V of'}"
          f" {cfg.num_kv_heads} x {cfg.head_dim} bf16 lanes); decode step: "
          f"engine {engine_step_ms:.3f} ms, device (graph replay) "
          f"{step_ms:.3f} ms, bytes floor {floor_ms:.3f} ms "
          f"({wbytes / 1e9:.3f} GB weights + {kvbytes / 1e9:.4f} GB KV); "
          f"device idle share of the engine step {idle:.3f}", flush=True)
    del eng
    return tps


PATH_SETUP = {"int8": ("int8", "bf16", False), "bf16": ("bf16", "bf16", False),
              "prefix": ("int8", "bf16", True),
              "int8kv": ("int8", "int8", False),
              "int8kv_prefix": ("bf16", "int8", True),
              "spec": ("bf16", "bf16", False),
              "spec_int8kv": ("int8", "int8", False),
              "fp8kv": ("int8", "fp8", False),
              "fp8kv_prefix": ("bf16", "fp8", True),
              "spec_fp8kv": ("int8", "fp8", False),
              "dense": ("int8", "bf16", False),
              "dense_fp8kv": ("int8", "fp8", False),
              "dense_bf16": ("bf16", "bf16", False),
              "draft": ("bf16", "bf16", False),
              "int4": ("int4", "bf16", False),
              "int4_dense": ("int4", "bf16", False),
              "w8a8": ("int8", "bf16", True),
              "mistral_window": ("int8", "bf16", False),
              "gemma": ("int8", "bf16", False),
              "gemma_prefix": ("bf16", "bf16", True),
              "gemma2": ("int8", "bf16", False),
              "gemma2_window": ("bf16", "bf16", False),
              "gemma2_dense": ("int8", "bf16", False),
              "gemma2_dense_fp8kv": ("int8", "fp8", False),
              "gemma2_spec": ("bf16", "bf16", False),
              "gemma2_draft": ("bf16", "bf16", False),
              "gpt_oss": ("int8", "bf16", False),
              "gpt_oss_prefix": ("bf16", "bf16", True),
              "gpt_oss_spec": ("bf16", "bf16", False),
              "gpt_oss_dense": ("int8", "bf16", False),
              "gpt_oss_dense_fp8kv": ("int8", "fp8", False),
              "gpt_oss_spec_int8kv": ("bf16", "int8", True),
              "gpt_oss_int8kv": ("int8", "int8", False),
              "gpt_oss_fp8kv": ("int8", "fp8", False),
              "gpt_oss_spec_fp8kv": ("bf16", "fp8", True),
              "gemma_int8kv_prefix": ("int8", "int8", True),
              "gemma_fp8kv_prefix": ("int8", "fp8", True),
              "gemma2_int8kv": ("int8", "int8", False),
              "gemma2_fp8kv": ("int8", "fp8", False),
              "gemma2_spec_int8kv": ("bf16", "int8", True),
              "gemma2_spec_fp8kv": ("bf16", "fp8", True),
              "mla": ("bf16", "bf16", True),
              "mla_naive": ("bf16", "bf16", True)}
# paths cut in depth to keep the run within half its time limit (their
# launch counts follow the cut: every count is per layer; a Gemma-2 or
# gpt-oss cut keeps the sliding/full alternation): `int8` keeps
# Llama-2-7B's 32 layers; the drafters run at DRAFT_LAYERS
PATH_LAYERS = {"gpt_oss": 4, "gpt_oss_prefix": 4, "gpt_oss_spec": 4,
               "gpt_oss_dense": 4,
               "spec": 4, "spec_int8kv": 4, "spec_fp8kv": 4, "bf16": 4,
               "dense_bf16": 4, "int4": 4, "int4_dense": 4,
               "mistral_window": 4, "gemma2": 4, "gemma2_window": 4,
               "gemma2_dense": 4, "gemma2_spec": 4, "gemma2_draft": 4,
               "gemma_prefix": 4, "draft": 4, "dense": 4, "prefix": 4,
               "w8a8": 4, "int8kv": 4, "int8kv_prefix": 4, "fp8kv": 4,
               "fp8kv_prefix": 4, "gemma": 4, "gpt_oss_spec_int8kv": 4,
               "gpt_oss_int8kv": 4, "gpt_oss_fp8kv": 4,
               "gpt_oss_spec_fp8kv": 4, "gemma_int8kv_prefix": 4,
               "gemma_fp8kv_prefix": 4, "gemma2_int8kv": 4,
               "gemma2_fp8kv": 4, "gemma2_spec_int8kv": 4,
               "gemma2_spec_fp8kv": 4, "dense_fp8kv": 4,
               "gemma2_dense_fp8kv": 4, "gpt_oss_dense_fp8kv": 4,
               "mla": 4, "mla_naive": 4}
def phase_engine(torch, launches: dict, paths=PATHS):
    import dataclasses

    from simplellminference_tpu_torch.core.config import ModelConfig
    from simplellminference_tpu_torch.models import llama

    cfg = ModelConfig.llama2_7b(dtype="bfloat16")
    draws = {"int8": int8_params, "int4": int4_params}
    ttft = {}
    rates = {}
    seconds = {}
    params, drawn = None, None
    full = cfg
    for path in paths:
        weights, kv_dtype, prefix = PATH_SETUP[path]
        int8 = weights == "int8"
        cfg = dataclasses.replace(full, num_layers=PATH_LAYERS.get(
            path, full.num_layers))
        if path == "mistral_window":
            cfg = ModelConfig.mistral_7b(
                sliding_window=WINDOW, dtype="bfloat16",
                num_layers=PATH_LAYERS.get(path, 32))
        if path in ("gemma", "gemma_prefix", "gemma_int8kv_prefix",
                    "gemma_fp8kv_prefix"):
            cfg = ModelConfig.gemma_2b(dtype="bfloat16",
                                       num_layers=PATH_LAYERS[path])
        if path.startswith("gemma2"):
            cfg = (gemma2_9b(PATH_LAYERS.get(path, 42))
                   if path == "gemma2_draft"
                   else gemma2_2b(PATH_LAYERS.get(path, 26)))
        if path.startswith("gpt_oss"):
            cfg = gpt_oss_20b(PATH_LAYERS.get(path, 24))
        # the MLA paths' weights are one draw whatever the cache mode
        key = cfg
        if path in ("mla", "mla_naive"):
            cfg = mla_config(PATH_LAYERS[path], absorbed=path == "mla")
            key = mla_config(PATH_LAYERS[path])
        t0 = time.perf_counter()
        # a path of the previous path's model, depth and weights serves
        # the same draw (no path writes to its weights)
        shared = (weights, key) == drawn
        if not shared:
            del params
            torch.cuda.empty_cache()
            if cfg.num_experts:
                params = moe_params(torch, cfg, "cuda", int8)
            elif weights in draws:
                params = draws[weights](torch, cfg, "cuda", seed=0)
            else:
                params = llama.init_params(cfg, seed=0, device="cuda")
            drawn = (weights, key)
        torch.cuda.synchronize()
        how = "the previous path's draw" if shared else "drawn"
        print(f"[engine:{path}] {cfg.model_type} width, {cfg.num_layers} "
              f"layers, {weights} random weights ({how}), {kv_dtype} KV, "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        if path in ("mla", "mla_naive"):
            rates[path] = serve_mla(torch, path, cfg, params, launches)
            if path == "mla_naive" and "mla" in STEPS:
                print(f"[engine:mla_naive] device step naive / absorbed "
                      f"{STEPS['mla_naive'][1] / STEPS['mla'][1]:.4f}; "
                      f"decode rate absorbed / naive "
                      f"{rates['mla'] / rates['mla_naive']:.4f}; KV bytes "
                      f"per token and layer naive / absorbed "
                      f"{mla_kv_bytes_per_token(cfg)} / "
                      f"{mla_kv_bytes_per_token(mla_config(1))}",
                      flush=True)
        elif path == "w8a8":
            # the server CLI's --act-quant: W8A8 prefill, the prefix traffic
            ttft[path] = serve_prefix(
                torch, path, dataclasses.replace(cfg, act_quant="int8"),
                params, launches, int8, kv_dtype)
            base = ttft.get("prefix", [])
            print(f"[engine:w8a8] max TTFT of each wave, W8A8 prefill "
                  f"{ttft['w8a8']} ms beside the prefix path's W8A16 "
                  f"{base} ms (ratios "
                  f"{[a / b for a, b in zip(ttft['w8a8'], base)]})",
                  flush=True)
        elif path.startswith("dense") or path in ("int4_dense",
                                                  "gpt_oss_dense",
                                                  "gpt_oss_dense_fp8kv"):
            serve_dense(torch, path, cfg, params, launches, int8,
                        int4=weights == "int4", kv_dtype=kv_dtype)
        elif path in ("gemma2_dense", "gemma2_dense_fp8kv"):
            # bench.py's fused loop over 4 prompts past the window: the
            # sliding layers' 13wc trims from the first step
            serve_dense(torch, path, cfg, params, launches, int8, batch=4,
                        prompt_len=4224, max_seq=4608, kv_dtype=kv_dtype)
        elif path == "draft":
            serve_draft(torch, path, cfg, params, launches)
        elif path == "gemma2_draft":
            serve_draft(torch, path, cfg, params, launches,
                        draft_cfg=gemma2_2b(DRAFT_LAYERS),
                        draft_name="Gemma-2-2B")
        elif path.startswith("spec") or path in ("gemma2_spec",
                                                 "gpt_oss_spec"):
            serve_spec(torch, path, cfg, params, launches, int8, kv_dtype)
        elif path in ("gpt_oss_spec_int8kv", "gemma2_spec_int8kv",
                      "gpt_oss_spec_fp8kv", "gemma2_spec_fp8kv"):
            # the server CLI's --kv-dtype int8 (fp8) --spec-tokens 4 on the
            # prefix path's traffic
            serve_spec(torch, path, cfg, params, launches, int8, kv_dtype,
                       prefix=True)
        elif prefix:
            ttft[path] = serve_prefix(torch, path, cfg, params, launches,
                                      int8, kv_dtype)
            if path in ("gemma_prefix", "gpt_oss_prefix",
                        "gemma_int8kv_prefix", "gemma_fp8kv_prefix"):
                rates[path] = prefix_decode(torch, path, cfg, params,
                                            kv_dtype)
        elif path == "gemma2_window":
            # bf16 weights, chunked prefill past the window: the long run
            launches[path] = serve_mistral_window(torch, path, cfg, params,
                                                  launches, int8=False)
        elif path == "mistral_window":
            # the long run, then bench.py's shape (8 x 128-token prompts,
            # 32 new tokens: a whole-prompt dispatch, R 33) for the rate;
            # the path's launches are both runs'
            long_run = serve_mistral_window(torch, path, cfg, params,
                                            launches)
            rates[path] = serve_path(torch, path, cfg, params, launches,
                                     int8, kv_dtype)
            launches[path] = {k: n + long_run[k]
                              for k, n in launches[path].items()}
            print(f"[engine:{path}] decode {rates[path]} tok/s at bench.py's "
                  f"shape beside the int8 path's {rates.get('int8')} "
                  f"(Llama-2-7B, same call)", flush=True)
        else:
            rates[path] = serve_path(torch, path, cfg, params, launches,
                                     int8, kv_dtype, int4=weights == "int4")
        if path == "int8kv":
            long_context_steps(torch, cfg, params)
        if path in TWINS and TWINS[path] in STEPS:
            print(f"[engine:{path}] step (engine or loop, device, floor ms; "
                  f"idle share) {STEPS[path]} beside its twin "
                  f"{TWINS[path]}'s {STEPS[TWINS[path]]}", flush=True)
        seconds[path] = round(time.perf_counter() - t0, 1)
        print(f"[engine:{path}] path took {seconds[path]} s", flush=True)
    del params
    torch.cuda.empty_cache()
    print(f"[engine] seconds per path {json.dumps(seconds)}", flush=True)


def _trace(torch, cfg, params, prompts, steps, device, kv_dtype="f32",
           force=None):
    """Greedy prefill + decode through forward_paged over ``kv_dtype``
    pools; returns (tokens [R, steps+1], logits [steps+1, R, V], and for
    INT8 and FP8 KV the pools' codes after each call (e4m3 ones as their
    bytes), else None) on the host. ``force`` (FP8 KV): another run's
    codes after each call, which replace this run's pools once its own
    are taken, so each step attends the other run's cache and only the
    rows it writes itself may differ."""
    from simplellminference_tpu_torch.core.config import next_power_of_2
    from simplellminference_tpu_torch.memory.paged_kv import (
        PagedKVCache, kv_storage_dtype)
    from simplellminference_tpu_torch.models import llama

    r = len(prompts)
    ps, mp = 16, 8
    # absorbed MLA: one shared latent pool, as the Engine creates it
    cache = PagedKVCache.create(cfg.num_layers, r * mp, cfg.num_kv_heads,
                                ps, cfg.head_dim, kv_storage_dtype(kv_dtype),
                                shared_kv=cfg.mla and cfg.mla_absorbed,
                                device=device)
    tables = torch.arange(r * mp, dtype=torch.int32,
                          device=device).reshape(r, mp)
    bucket = next_power_of_2(max(max(len(p) for p in prompts), 16))
    toks = torch.zeros((r, bucket), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device=device)
    pos0 = torch.arange(bucket, dtype=torch.int32, device=device)[None]
    logits, cache = llama.forward_paged(cfg, params, toks.to(device), pos0,
                                        cache, tables, lens, prefill=True,
                                        last_token_only=True)
    fp8 = cache.k.dtype == torch.float8_e4m3fn
    int8 = cache.k_scale is not None or fp8

    def take_codes():
        pools = (cache.k, cache.v)
        if fp8:
            pools = tuple(p.view(torch.uint8) for p in pools)
        codes.append(torch.stack(pools).cpu())
        if force is not None:
            for pool, c in zip(pools, force[len(codes) - 1]):
                pool.copy_(c.to(pool.device))
    codes = [] if int8 else None
    if int8:
        take_codes()
    outs = [logits[:, -1].cpu()]
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    out_toks = [tok.cpu()]
    pos = lens.clone()
    for _ in range(steps):
        logits, cache = llama.forward_paged(cfg, params, tok[:, None],
                                            pos[:, None], cache, tables,
                                            pos + 1, prefill=False)
        outs.append(logits[:, 0].cpu())
        tok = logits[:, 0].argmax(-1).to(torch.int32)
        out_toks.append(tok.cpu())
        if int8:
            take_codes()
        pos = pos + 1
    return torch.stack(out_toks, 1), torch.stack(outs, 0), codes


def _to_device(tree, dev):
    from simplellminference_tpu_torch.ops.linear import QuantizedWeight
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(q=tree.q.to(dev), scales=tree.scales.to(dev),
                               bits=tree.bits,
                               zs=None if tree.zs is None else tree.zs.to(dev))
    return tree.to(dev)


class _ActCodes:
    """While active, records the codes of every quantize_activations_int8
    call (the W8A8 prefill products), as [M, K] rows on the host. With
    ``force`` (another run's record), each call instead hands on that
    run's codes and scales, after requiring its own codes to lie within
    one step of them: two devices sum the same f32 activations in other
    orders, a value on a rounding midpoint takes either code, and one
    code a step apart moves every later activation a little (measured at
    7B width on an NVIDIA H100 80GB HBM3 at 700.00 W: 7.3-7.8% of the
    codes of a free-running card and CPU apart after two layers, logits
    0.17 or more apart), so card and CPU are held to each other on the
    same codes."""

    def __init__(self, tag: str = "", force=None):
        self.tag, self.force = tag, force

    def __enter__(self):
        from simplellminference_tpu_torch.ops import matmul as mm
        self.mm, self.orig, self.codes = mm, mm.quantize_activations_int8, []

        def spy(x):
            xi, xs = self.orig(x)
            rows = xi.reshape(-1, xi.shape[-1]).cpu()
            self.codes.append(rows)
            if self.force is None:
                return xi, xs
            i = len(self.codes) - 1
            require(i < len(self.force[0]), f"[{self.tag}] more W8A8 calls "
                    f"than the reference run's {len(self.force[0])}")
            ref_xi, ref_xs = self.force[0][i], self.force[1][i]
            require(ref_xi.shape == rows.shape and int(
                (ref_xi.int() - rows.int()).abs().max()) <= 1,
                f"[{self.tag}] W8A8 call {i}: codes more than a step from "
                f"the reference run's")
            return (ref_xi.reshape(xi.shape).to(xi.device),
                    ref_xs.reshape(xs.shape).to(xs.device))
        self.scales = []
        if self.force is None:
            def record(x, _spy=spy):
                xi, xs = _spy(x)
                self.scales.append(xs.reshape(-1, 1).cpu())
                return xi, xs
            mm.quantize_activations_int8 = record
        else:
            mm.quantize_activations_int8 = spy
        return self

    def __exit__(self, *exc):
        self.mm.quantize_activations_int8 = self.orig

    def replay(self):
        """This run's (codes, scales), to force on another run."""
        return self.codes, self.scales


def _act_apart(a, b) -> int:
    """Activation codes apart between two runs' W8A8 calls."""
    require(len(a) == len(b), f"{len(a)} vs {len(b)} W8A8 calls")
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def _first_divergence(torch, tag, what, a, b, logits, r, tol=LOGIT_TOL):
    """Greedy rows a and b may part only where the reference logits'
    top-2 margin at that step is below ``tol``."""
    t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if t is None:
        return
    top2 = torch.topk(logits[t, r], 2).values
    margin = float(top2[0] - top2[1])
    require(margin < tol, f"[{tag}] request {r} step {t}: {what} "
            f"differ with top-2 margin {margin:.3e}")
    print(f"[cpu:{tag}] request {r}: {what} diverge at step {t}: top-2 "
          f"margin {margin:.3e} < {tol}", flush=True)


def card_vs_cpu(torch, tag, cfg, p_gpu, p_cpu, prompts, steps,
                kv_dtype="f32"):
    """Greedy trace and Engine run of the same weights on the card and on
    the host CPU over ``kv_dtype`` pools: logits within LOGIT_TOL (INT8
    and FP8 KV: while both caches hold the same codes, else within
    LOGIT_TOL_CODE_APART; INT8 codes at most one step apart, FP8 layer
    0's), greedy tokens equal except where the CPU trace's top-2 margin is
    below that tolerance."""
    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.engine import Engine

    t0 = time.perf_counter()
    with _ActCodes(tag) as act_c:
        tok_c, lg_c, codes_c = _trace(torch, cfg, p_cpu, prompts, steps,
                                      "cpu", kv_dtype)
    if act_c.codes:
        # W8A8 (cfg.act_quant): once free-running, then on the CPU's codes
        with _ActCodes(tag) as act_free:
            lg_free = _trace(torch, cfg, p_gpu, prompts, steps, "cuda",
                             kv_dtype)[1]
        print(f"[cpu:{tag}] W8A8 calls {len(act_c.codes)}; free-running "
              f"card vs CPU: activation codes apart "
              f"{_act_apart(act_free.codes, act_c.codes)} of "
              f"{sum(c.numel() for c in act_c.codes)}, logits max|card - "
              f"cpu| {max_err(lg_free, lg_c):.3e} (no bound: the card "
              f"below carries on with the CPU's codes)", flush=True)
    force = None
    if kv_dtype == "fp8":
        # an e4m3 code a step apart moves its value by up to 1/8 (an INT8
        # code's step is 1/127 of its row's absmax), and the drift compounds
        # over the steps: free-running, the card's logits parted from the
        # CPU's by 1.408e-2 at step 7 (7B width, 2 layers, INT8 weights; an
        # NVIDIA H100 80GB HBM3 at 700.00 W), past LOGIT_TOL_CODE_APART. So
        # the card carries on with the CPU's codes, as W8A8 does with its
        # activation codes, and each step is held with only its own rows'
        # codes apart; the free-running gap is printed, not held
        lg_free = _trace(torch, cfg, p_gpu, prompts, steps, "cuda",
                         kv_dtype)[1]
        print(f"[cpu:{tag}] free-running card vs CPU over fp8 KV: logits "
              f"max|card - cpu| {max_err(lg_free, lg_c):.3e} (no bound: the "
              f"card below carries on with the CPU's codes)", flush=True)
        force = codes_c
    with _ActCodes(tag, force=act_c.replay() if act_c.codes else None
                   ) as act_g:
        tok_g, lg_g, codes_g = _trace(torch, cfg, p_gpu, prompts, steps,
                                      "cuda", kv_dtype, force=force)
    if act_c.codes:
        print(f"[cpu:{tag}] on the CPU's codes, the card's own were apart "
              f"in {_act_apart(act_g.codes, act_c.codes)} (each at most "
              f"one step)", flush=True)
    print(f"[cpu:{tag}] {_width(cfg)}, {cfg.num_layers} layers, f32, "
          f"{kv_dtype} KV, "
          f"TF32 off: "
          f"{len(prompts)} requests, prefill + {steps} steps on card and "
          f"CPU in {time.perf_counter() - t0:.1f} s", flush=True)
    # codes one apart between the card's and the CPU's caches, per call
    apart = [0] * (steps + 1)
    far_all = None
    if codes_g is not None:
        apart = [int((a != b).sum()) for a, b in zip(codes_g, codes_c)]
        # an e4m3 step is relative to its value: a code apart in one layer
        # moves the next layers' inputs by ~1e-3, several steps of their
        # smallest values (measured at 7B width, 2 layers, on an NVIDIA
        # H100 80GB HBM3 at 700.00 W: 2 steps near 2^-9), so FP8 holds
        # layer 0, computed from the same embeddings on both devices, to
        # one step and leaves later layers to the logit rule; an INT8
        # code's step is its row's absmax / 127, and every layer is held
        held = slice(0, 1) if kv_dtype == "fp8" else slice(None)
        order = ((lambda c: _e4m3_ordinal(torch, c)) if kv_dtype == "fp8"
                 else (lambda c: c.int()))
        far = max(int((order(a[:, held]) - order(b[:, held])).abs().max())
                  for a, b in zip(codes_g, codes_c))
        far_all = max(int((order(a) - order(b)).abs().max())
                      for a, b in zip(codes_g, codes_c))
        require(far <= 1, f"[{tag}] card and CPU codes {far} apart")
    worst = {True: 0.0, False: 0.0}
    for r in range(len(prompts)):
        for t in range(steps + 1):
            tol = LOGIT_TOL if apart[t] == 0 else LOGIT_TOL_CODE_APART
            e = max_err(lg_g[t, r], lg_c[t, r])
            worst[apart[t] == 0] = max(worst[apart[t] == 0], e)
            require(e <= tol, f"[{tag}] request {r} step {t}: logits differ "
                    f"by {e:.3e} ({apart[t]} codes one apart)")
            if int(tok_g[r, t]) != int(tok_c[r, t]):
                top2 = torch.topk(lg_c[t, r], 2).values
                margin = float(top2[0] - top2[1])
                require(margin < tol,
                        f"[{tag}] request {r} step {t}: greedy tokens differ "
                        f"with top-2 margin {margin:.3e}")
                print(f"[cpu:{tag}] request {r} diverges at step {t}: top-2 "
                      f"margin {margin:.3e} < {tol}", flush=True)
                break
    codes_note = (f"; {kv_dtype} codes apart after each call (layer 0 at "
                  f"most one step, every layer {far_all}): {apart} of "
                  f"{codes_g[0].numel()}; logits max|card - cpu| where "
                  f"codes are apart {worst[False]:.3e} (tol "
                  f"{LOGIT_TOL_CODE_APART})" if codes_g is not None else "")
    print(f"[cpu:{tag}] logits max|card - cpu| {worst[True]:.3e} (tol "
          f"{LOGIT_TOL}){codes_note}; greedy tokens equal: "
          f"{bool(torch.equal(tok_g, tok_c))}", flush=True)
    tol = LOGIT_TOL if codes_g is None else LOGIT_TOL_CODE_APART

    # the same requests through the Engine on both devices: greedy outputs
    # equal, or diverging only where the trace's top-2 margin is below the
    # tolerance (the engine batch is the trace's)
    ecfg = EngineConfig(max_batch_size=len(prompts), prefix_cache_entries=0,
                        kv=KVCacheConfig(page_size=16, num_pages=64,
                                         max_pages_per_seq=8,
                                         kv_dtype=kv_dtype))
    samp = SamplingParams(max_new_tokens=steps + 1)
    outs = {}
    force = None
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        # W8A8: the card's engine on the CPU engine's activation codes
        with _ActCodes(tag, force=force) as act:
            eng = Engine(cfg, params, ecfg, decode_burst=4, device=dev)
            outs[dev] = eng.generate(prompts, samp)
        force = act.replay() if act.codes else None
    outs = [outs["cuda"], outs["cpu"]]
    for r, (a, b) in enumerate(zip(*outs)):
        require(len(a) == len(b) == steps + 1,
                f"[{tag}] engine request {r} short")
        require(b == tok_c[r].tolist(),
                f"[{tag}] engine request {r} on the CPU departs from the "
                f"trace")
        _first_divergence(torch, tag, "engine on card and CPU", a, b, lg_c,
                          r, tol)
    print(f"[cpu:{tag}] engine greedy tokens card == cpu: "
          f"{outs[0] == outs[1]}", flush=True)


def _width(cfg) -> str:
    """The model whose widths a check runs at, for its lines."""
    if cfg.model_type == "gemma2" and cfg.hidden_size == 3584:
        return "Gemma-2-9B width"
    return {"gemma": "Gemma-2B width", "gemma2": "Gemma-2-2B width",
            "mistral": "Mistral-7B width",
            "gpt_oss": "gpt-oss-20b width",
            "deepseek_v2": "DeepSeek-V2-Lite attention width"}.get(
                cfg.model_type, "Llama-2-7B width")


def prefix_card_vs_cpu(torch, cfg, p_gpu, p_cpu, kv_dtype="f32",
                       tag=None):
    """The `prefix` path's traffic at a small size (a 48-token system
    prompt, 8-token suffixes, page 16, chunk 16, waves of 1, 3 and 4) on
    the card and on the CPU: greedy tokens equal on both, and equal to
    the cache-off greedy trace of the same prompts, except where the
    trace's top-2 margin is below LOGIT_TOL. INT8 KV: card and CPU within
    LOGIT_TOL_CODE_APART by the same rule; the cache-off trace is no
    reference there (its whole-prompt prefill attends the fresh,
    unquantized k/v, the chunks attend the dequantized pools, as in the
    JAX package), so only card and CPU are compared. W8A8
    (``cfg.act_quant``): a 32-token system prompt with 32-token suffixes
    and chunk 64, so that the suffix batch of 4 x 32 rows runs W8A8; the
    card's engine on the CPU engine's activation codes (``_ActCodes``),
    card and CPU by the LOGIT_TOL rule, and the card must launch the W8A8
    kernel. ``tag`` names the check (default: by the KV dtype). The
    grouped engine (a sliding-window model, GPT-OSS) shares no prefix, as
    in the JAX package: its waves prefill every prompt in chunks."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import SamplingParams
    from simplellminference_tpu_torch.engine import Engine
    from simplellminference_tpu_torch.ops import matmul as mm

    tag = tag or ("prefix" if kv_dtype == "f32" else f"prefix-{kv_dtype}kv")
    batch, system_len, suffix, new, burst, ps, chunk = 4, 48, 8, 8, 4, 16, 16
    if cfg.act_quant:
        tag, system_len, suffix, chunk = "prefix-w8a8", 32, 32, 64
    w8a8_before = mm.quantized_matmul_w8a8.launches
    waves = prefix_waves(np.random.default_rng(9), cfg.vocab_size,
                         system_len, suffix, batch)
    prompts = sum(waves, [])
    t0 = time.perf_counter()
    tok_c, lg_c, _codes = _trace(torch, cfg, p_cpu, prompts, new - 1, "cpu",
                                 kv_dtype)
    # W8A8: the cache-off trace runs other products than the chunks and
    # suffix batches, so it is no reference for the tokens; the card's
    # engine runs on the CPU engine's activation codes (_ActCodes)
    int8 = kv_dtype == "int8"
    outs = {}
    force = None
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        with _ActCodes(tag, force=force) as act:
            eng = Engine(cfg, params, prefix_engine_config(
                batch, ps, chunk, system_len + suffix + new + 2 * burst + 1,
                kv_dtype), decode_burst=burst, device=dev)
            reqs = sum(run_waves(eng, waves,
                                 SamplingParams(max_new_tokens=new)), [])
        force = act.replay() if act.codes else None
        m = eng.metrics
        hits = (0, 0) if eng._grouped else (2 * batch - 1, batch)
        require((m.prefix_cache_hits, m.prefix_cache_persistent_hits)
                == hits, f"[{tag}] {dev} prefix metrics {m.summary()}")
        require(all(len(r.output_ids) == new for r in reqs),
                f"[{tag}] {dev} requests short")
        outs[dev] = [r.output_ids for r in reqs]
    w8a8_launches = mm.quantized_matmul_w8a8.launches - w8a8_before
    require(bool(cfg.act_quant) == (w8a8_launches > 0),
            f"[{tag}] {w8a8_launches} W8A8 launches on the card")
    for r in range(len(prompts)):
        ref = tok_c[r].tolist()
        _first_divergence(torch, tag, "card and CPU", outs["cuda"][r],
                          outs["cpu"][r], lg_c, r,
                          LOGIT_TOL_CODE_APART if int8 else LOGIT_TOL)
        if int8 or cfg.act_quant:
            continue
        for dev in outs:
            _first_divergence(torch, tag,
                              f"{dev} prefix path and cache-off trace",
                              outs[dev][r], ref, lg_c, r)
    print(f"[cpu:{tag}] {_width(cfg)}, {cfg.num_layers} layers, f32, "
          f"{kv_dtype} KV: "
          f"{len(prompts)} "
          f"requests in waves of 1, {batch - 1}, {batch} (prefix hits "
          f"{hits[0]}, persistent {hits[1]}) on card and CPU in "
          f"{time.perf_counter() - t0:.1f} s; greedy tokens card == cpu: "
          f"{outs['cuda'] == outs['cpu']}, == cache-off trace: "
          f"{outs['cpu'] == tok_c.tolist()}; W8A8 launches on the card "
          f"{w8a8_launches}", flush=True)


def spec_card_vs_cpu(torch, tag, cfg, p_gpu, p_cpu, kv_dtype="f32",
                     new: int = 16):
    """The spec Engine (spec_tokens 4, burst 4) on the card and on the CPU,
    4 greedy requests (two repeating a pattern, one whose logit_bias
    forces a token) x ``new`` tokens: greedy tokens equal on both devices, to
    the same Engine with spec_tokens=0 on the CPU and (unbiased) to the
    CPU's greedy trace, except where the trace's top-2 margin is below
    the tolerance (LOGIT_TOL; LOGIT_TOL_CODE_APART over INT8 KV); where
    the card's and the CPU's tokens agree, their spec_steps and
    spec_accepted agree too."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.engine import Engine

    prompts = spec_prompts(np.random.default_rng(11), cfg.vocab_size, 4, 48)
    # the last request's logit_bias forces one token, so its history
    # repeats and its drafts are accepted: the accepted-span bookkeeping
    # runs on both devices (the unbiased trace is no reference for it)
    forced = 7
    samps = [SamplingParams(max_new_tokens=new)] * 3 + [SamplingParams(
        max_new_tokens=new, logit_bias=((forced, 100.0),))]
    t0 = time.perf_counter()
    tok_c, lg_c, _codes = _trace(torch, cfg, p_cpu, prompts, new - 1, "cpu",
                                 kv_dtype)
    tol = LOGIT_TOL_CODE_APART if kv_dtype == "int8" else LOGIT_TOL

    def ecfg(spec):
        return EngineConfig(max_batch_size=4, spec_tokens=spec,
                            prefix_cache_entries=0,
                            kv=KVCacheConfig(page_size=16, num_pages=64,
                                             max_pages_per_seq=8,
                                             kv_dtype=kv_dtype))

    plain = Engine(cfg, p_cpu, ecfg(0), decode_burst=4,
                   device="cpu").generate(prompts, samps)
    require(plain[-1] == [forced] * new,
            f"[{tag}] spec_tokens=0: biased request {plain[-1]}")
    outs, metrics = {}, {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        eng = Engine(cfg, params, ecfg(4), decode_burst=4, device=dev)
        outs[dev] = eng.generate(prompts, samps)
        metrics[dev] = (eng.metrics.spec_steps, eng.metrics.spec_accepted)
        require(outs[dev][-1] == [forced] * new and metrics[dev][1] > 0,
                f"[{tag}] {dev}: biased request {outs[dev][-1]}, spec "
                f"metrics {metrics[dev]}")
        require(all(len(o) == new for o in outs[dev]),
                f"[{tag}] {dev} requests short")
    for r in range(len(prompts)):
        _first_divergence(torch, tag, "card and CPU", outs["cuda"][r],
                          outs["cpu"][r], lg_c, r, tol)
        for dev in outs:
            if r == len(prompts) - 1:
                continue                # biased: no trace to hold it to
            _first_divergence(torch, tag,
                              f"{dev} spec engine and greedy trace",
                              outs[dev][r], tok_c[r].tolist(), lg_c, r, tol)
            _first_divergence(torch, tag,
                              f"{dev} spec engine and spec_tokens=0",
                              outs[dev][r], plain[r], lg_c, r, tol)
    if outs["cuda"] == outs["cpu"]:
        require(metrics["cuda"] == metrics["cpu"],
                f"[{tag}] spec_steps/spec_accepted card {metrics['cuda']}, "
                f"cpu {metrics['cpu']}")
    print(f"[cpu:{tag}] {_width(cfg)}, {cfg.num_layers} layers, f32, "
          f"{kv_dtype} KV, "
          f"spec_tokens 4: {len(prompts)} requests x {new} tokens on card "
          f"and CPU in {time.perf_counter() - t0:.1f} s; (spec_steps, "
          f"spec_accepted) card {metrics['cuda']}, cpu {metrics['cpu']}; "
          f"greedy tokens card == cpu: {outs['cuda'] == outs['cpu']}, "
          f"== the same engine with spec_tokens=0: "
          f"{outs['cpu'] == plain}, unbiased ones == the greedy trace: "
          f"{outs['cpu'][:-1] == tok_c.tolist()[:-1]}", flush=True)


def dense_card_vs_cpu(torch, tag, cfg, p_gpu, p_cpu, prompts, steps):
    """The Generator on the card and on the CPU: a greedy prefill + decode
    trace through its steps (logits within LOGIT_TOL), then ``generate``
    and ``generate_fused``, whose greedy tokens must equal the CPU trace's
    except where its top-2 margin is below LOGIT_TOL."""
    from simplellminference_tpu_torch.core.config import SamplingParams
    from simplellminference_tpu_torch.ops import sampling
    from simplellminference_tpu_torch.runtime.generator import Generator

    t0 = time.perf_counter()
    traces, outs = {}, {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        gen = Generator(cfg, params, max_batch=len(prompts), max_seq=256,
                        device=dev)
        cache = gen.new_cache(len(prompts), 128 + steps + 1)
        logits, cache, lens = gen.prefill(cache, prompts)
        pos = gen._tensor(lens)
        lg = [logits.cpu()]
        tok = sampling.greedy(logits)
        toks = [tok.cpu()]
        for _ in range(steps):
            logits, cache = gen._decode_fn(tok, pos, cache)
            lg.append(logits.cpu())
            tok = sampling.greedy(logits)
            toks.append(tok.cpu())
            pos = pos + 1
        traces[dev] = (torch.stack(toks, 1), torch.stack(lg, 0))
        outs[dev] = (gen.generate(prompts, SamplingParams(
            max_new_tokens=steps + 1)).token_ids,
            gen.generate_fused(prompts, steps + 1).cpu().tolist())
    tok_c, lg_c = traces["cpu"]
    err = max_err(traces["cuda"][1], lg_c)
    require(err <= LOGIT_TOL, f"[{tag}] Generator logits card vs CPU {err}")
    for r in range(len(prompts)):
        ref = tok_c[r].tolist()
        for dev in outs:
            for what, got in zip(("generate", "generate_fused"), outs[dev]):
                _first_divergence(torch, tag, f"{dev} {what} and the CPU "
                                  f"trace", got[r], ref, lg_c, r)
    print(f"[cpu:{tag}] Generator, {_width(cfg)}, {cfg.num_layers} "
          f"layers, f32: "
          f"{len(prompts)} requests, prefill + {steps} steps on card and CPU "
          f"in {time.perf_counter() - t0:.1f} s; logits max|card - cpu| "
          f"{err:.3e} (tol {LOGIT_TOL}); greedy tokens of generate and "
          f"generate_fused card == cpu: {outs['cuda'] == outs['cpu']}",
          flush=True)


def dense_fp8kv_card_vs_cpu(torch, tag, cfg, p_gpu, p_cpu, prompts, steps):
    """The Generator over an e4m3 arena on the card and on the CPU, by the
    FP8-KV rule of :func:`card_vs_cpu`: a greedy prefill + ``steps``
    decode steps through its steps on the CPU; on the card once
    free-running (the gap printed, not held: a code a step apart moves
    its value by up to 1/8, and the drift compounds) and once carrying on
    with the CPU's arena codes and tokens after each call: layer 0's codes
    (computed from the same embeddings on both devices) at most one e4m3
    step from the CPU's, logits within LOGIT_TOL while the call's codes
    agree and within LOGIT_TOL_CODE_APART once one parts; then
    ``generate`` and ``generate_fused`` on the card, their greedy tokens
    equal to the CPU trace's except where its top-2 margin is below
    LOGIT_TOL_CODE_APART."""
    from simplellminference_tpu_torch.core.config import SamplingParams
    from simplellminference_tpu_torch.ops import sampling
    from simplellminference_tpu_torch.runtime.generator import Generator

    t0 = time.perf_counter()
    e4 = torch.float8_e4m3fn

    def trace(dev, params, force=None):
        gen = Generator(cfg, params, max_batch=len(prompts), max_seq=256,
                        kv_dtype=e4, device=dev)
        cache = gen.new_cache(len(prompts), 128 + steps + 1)
        got = []

        def take():
            arenas = tuple(a.view(torch.uint8) for a in (cache.k, cache.v))
            got.append(torch.stack(arenas).cpu())
            if force is not None:
                for a, code in zip(arenas, force[2][len(got) - 1]):
                    a.copy_(code.to(a.device))

        logits, cache, lens = gen.prefill(cache, prompts)
        take()
        pos = gen._tensor(lens)
        lg, toks = [logits.cpu()], [sampling.greedy(logits).cpu()]
        for t in range(steps):
            tok = (toks[-1] if force is None else force[0][:, t]).to(
                pos.device)
            logits, cache = gen._decode_fn(tok, pos, cache)
            take()
            lg.append(logits.cpu())
            toks.append(sampling.greedy(logits).cpu())
            pos = pos + 1
        return torch.stack(toks, 1), torch.stack(lg, 0), got, gen

    cpu = trace("cpu", p_cpu)
    free = trace("cuda", p_gpu)
    print(f"[cpu:{tag}] free-running card vs CPU over an e4m3 arena: "
          f"logits max|card - cpu| {max_err(free[1], cpu[1]):.3e} (no bound:"
          f" the card below carries on with the CPU's codes)", flush=True)
    tok_g, lg_g, codes_g, gen = trace("cuda", p_gpu, force=cpu)
    tok_c, lg_c, codes_c = cpu[:3]
    apart = [int((a != b).sum()) for a, b in zip(codes_g, codes_c)]
    far = max(int((_e4m3_ordinal(torch, a[:, :1])
                   - _e4m3_ordinal(torch, b[:, :1])).abs().max())
              for a, b in zip(codes_g, codes_c))
    require(far <= 1, f"[{tag}] layer 0's codes {far} steps apart")
    worst = {True: 0.0, False: 0.0}
    for t in range(steps + 1):
        tol = LOGIT_TOL if apart[t] == 0 else LOGIT_TOL_CODE_APART
        e = max_err(lg_g[t], lg_c[t])
        worst[apart[t] == 0] = max(worst[apart[t] == 0], e)
        require(e <= tol, f"[{tag}] step {t}: logits differ by {e:.3e} "
                f"({apart[t]} codes apart)")
    outs = (gen.generate(prompts, SamplingParams(
        max_new_tokens=steps + 1)).token_ids,
        gen.generate_fused(prompts, steps + 1).cpu().tolist())
    for r in range(len(prompts)):
        for what, got in zip(("generate", "generate_fused"), outs):
            _first_divergence(torch, tag, f"card {what} and the CPU trace",
                              got[r], tok_c[r].tolist(), lg_c, r,
                              LOGIT_TOL_CODE_APART)
    print(f"[cpu:{tag}] Generator over an e4m3 arena, {_width(cfg)}, "
          f"{cfg.num_layers} layers, f32: {len(prompts)} requests, prefill + "
          f"{steps} steps on card and CPU in {time.perf_counter() - t0:.1f} "
          f"s; codes apart after each call (layer 0 at most one step): "
          f"{apart} of {codes_c[0].numel()}; logits max|card - cpu| "
          f"{worst[True]:.3e} (tol {LOGIT_TOL}), where codes are apart "
          f"{worst[False]:.3e} (tol {LOGIT_TOL_CODE_APART}); card greedy "
          f"tokens == the CPU trace's: "
          f"{outs[0] == tok_c.tolist() and outs[1] == tok_c.tolist()}",
          flush=True)


def draft_card_vs_cpu(torch, cfg, p_gpu, p_cpu, draft=None, tag="draft"):
    """The draft Engine (spec_tokens 4, burst 4) on the card and on the
    CPU, 4 greedy requests x 16 tokens, with the target as its own draft
    (every draft accepted on both devices) or ``draft`` = (draft config,
    its params on the card, on the CPU): the tokens equal the CPU's
    greedy trace of the target (except where the margin rule allows)."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.engine import Engine

    g, new = 4, 16
    prompts = spec_prompts(np.random.default_rng(13), cfg.vocab_size, 4, 48)
    samp = SamplingParams(max_new_tokens=new)
    t0 = time.perf_counter()
    tok_c, lg_c, _codes = _trace(torch, cfg, p_cpu, prompts, new - 1, "cpu")

    def ecfg(spec):
        return EngineConfig(max_batch_size=4, spec_tokens=spec,
                            prefix_cache_entries=0,
                            kv=KVCacheConfig(page_size=16, num_pages=64,
                                             max_pages_per_seq=8,
                                             kv_dtype="f32"))

    outs, metrics = {}, {}
    for i, (dev, params) in enumerate((("cuda", p_gpu), ("cpu", p_cpu))):
        eng = Engine(cfg, params, ecfg(g), decode_burst=4, device=dev,
                     draft=(cfg, params) if draft is None
                     else (draft[0], draft[1 + i]))
        outs[dev] = eng.generate(prompts, samp)
        m = eng.metrics
        metrics[dev] = (m.spec_steps, m.spec_accepted)
        require(m.spec_steps > 0 and (draft is not None
                                      or m.spec_accepted == g * m.spec_steps),
                f"[{tag}] {dev}: a self-draft left drafts unaccepted "
                f"{metrics[dev]}")
    for r in range(len(prompts)):
        for dev in outs:
            _first_divergence(torch, tag, f"{dev} draft engine and the "
                              f"greedy trace", outs[dev][r],
                              tok_c[r].tolist(), lg_c, r)
    by = ("itself" if draft is None
          else f"{_width(draft[0])} at {draft[0].num_layers} layers")
    print(f"[cpu:{tag}] {_width(cfg)}, {cfg.num_layers} layers, f32, "
          f"drafted by {by} "
          f"(spec_tokens {g}): {len(prompts)} requests x {new} tokens on "
          f"card and CPU in {time.perf_counter() - t0:.1f} s; (spec_steps, "
          f"spec_accepted) card {metrics['cuda']}, cpu {metrics['cpu']}; "
          f"greedy tokens card == cpu: "
          f"{outs['cuda'] == outs['cpu']}, == the greedy trace: "
          f"{outs['cpu'] == tok_c.tolist()}", flush=True)


def quantize_card_vs_cpu(torch, p_cpu, q_cpu):
    """``quantize_params`` on the card against the CPU's, byte for byte;
    and how many scales PyTorch's CUDA division by the Python scalar 127
    would have given otherwise (the port divides by a tensor)."""
    from simplellminference_tpu_torch.core.config import QuantConfig
    from simplellminference_tpu_torch.runtime.weights import quantize_params

    q_gpu = quantize_params(_to_device(p_cpu, "cuda"), QuantConfig(
        mode="int8", group_size=0, quantize_lm_head=True))
    same, scalar_apart, n = True, 0, 0
    for name in ("wqkv", "wo", "w_gate_up", "w_down", "lm_head"):
        a = q_cpu[name] if name == "lm_head" else q_cpu["layers"][name]
        b = q_gpu[name] if name == "lm_head" else q_gpu["layers"][name]
        same = same and torch.equal(a.q, b.q.cpu()) and torch.equal(
            a.scales, b.scales.cpu())
        w = (p_cpu[name] if name == "lm_head" else p_cpu["layers"][name]
             ).to("cuda")
        amax = w.abs().amax(dim=-2, keepdim=True)
        scalar_apart += int(((amax / 127.0).clamp_min(1e-8)
                             != b.scales).sum())
        n += b.scales.numel()
        del w, amax
    require(same, "quantize_params: card and CPU codes or scales differ")
    print(f"[cpu:quantize] quantize_params (per channel, INT8 LM head) of "
          f"the 7B-width 2-layer weights: codes and scales byte-equal card "
          f"vs CPU; CUDA division by the Python scalar 127 would give "
          f"{scalar_apart} of {n} scales apart", flush=True)
    del q_gpu


def awq_fetcher(cfg, seed: int):
    """An in-memory AWQ checkpoint of ``cfg`` (dense Llama, group 128) as
    ``fetch(hf_name) -> np.ndarray``: random packed int32 ``qweight`` and
    ``qzeros`` (every nibble a valid uint4 code and zero point), f16
    scales K**-0.5 / 6 varied per column, f32 embedding (x 0.02), norms of
    ones and a plain LM head. Returns (fetch, quantization_config)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    gs = 128
    t = {"model.embed_tokens.weight": rng.standard_normal(
             (v, h), dtype=np.float32) * np.float32(0.02),
         "model.norm.weight": np.ones((h,), np.float32),
         "lm_head.weight": rng.standard_normal(
             (v, h), dtype=np.float32) * np.float32(0.02)}

    def quantized(name, k, n):
        t[name + ".qweight"] = rng.integers(-2 ** 31, 2 ** 31, (k, n // 8),
                                            dtype=np.int32)
        t[name + ".qzeros"] = rng.integers(-2 ** 31, 2 ** 31,
                                           (k // gs, n // 8), dtype=np.int32)
        t[name + ".scales"] = ((rng.random((k // gs, n)) + 0.5)
                               * (k ** -0.5 / 6)).astype(np.float16)

    for li in range(cfg.num_layers):
        p = f"model.layers.{li}."
        t[p + "input_layernorm.weight"] = np.ones((h,), np.float32)
        t[p + "post_attention_layernorm.weight"] = np.ones((h,), np.float32)
        for nm, n in (("q", nd), ("k", kvd), ("v", kvd)):
            quantized(p + f"self_attn.{nm}_proj", h, n)
        quantized(p + "self_attn.o_proj", nd, h)
        for nm in ("gate", "up"):
            quantized(p + f"mlp.{nm}_proj", h, i)
        quantized(p + "mlp.down_proj", i, h)
    return t.__getitem__, dict(quant_method="awq", bits=4, group_size=gs,
                               version="gemm")


def _float_to(tree, dtype):
    """The tree with its float tensors (embedding, norms) in ``dtype``;
    quantized weights as they are."""
    from simplellminference_tpu_torch.ops.linear import QuantizedWeight
    if isinstance(tree, dict):
        return {k: _float_to(v, dtype) for k, v in tree.items()}
    if isinstance(tree, QuantizedWeight) or not tree.is_floating_point():
        return tree
    return tree.to(dtype)


def awq_bf16(torch, cfg, p_gpu, p_cpu, prompts, new: int = 5):
    """The AWQ weights with bf16 activations, the server's dtype (the f32
    check above runs the FMA kernels): the Engine on the card, through
    the INT4 product's tensor-core regimes, and on the CPU. Every request
    finishes with valid tokens on both; the greedy outputs equal card vs
    CPU are printed, not held (bf16 activations round by summation
    order, and random weights leave near-tied logits)."""
    import dataclasses

    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.engine import Engine

    cfg_bf = dataclasses.replace(cfg, dtype="bfloat16")
    ecfg = EngineConfig(max_batch_size=len(prompts), prefix_cache_entries=0,
                        kv=KVCacheConfig(page_size=16, num_pages=64,
                                         max_pages_per_seq=8,
                                         kv_dtype="bf16"))
    outs = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        eng = Engine(cfg_bf, _float_to(params, torch.bfloat16), ecfg,
                     decode_burst=4, device=dev)
        outs[dev] = eng.generate(prompts, SamplingParams(max_new_tokens=new))
        for o in outs[dev]:
            require(len(o) == new and all(0 <= t < cfg.vocab_size
                                          for t in o),
                    f"[awq-bf16] {dev} output {o}")
    same = sum(a == b for a, b in zip(outs["cuda"], outs["cpu"]))
    print(f"[cpu:awq-bf16] bf16 activations, {len(prompts)} requests x "
          f"{new} tokens: greedy outputs card == cpu in {same} of "
          f"{len(prompts)}", flush=True)


def _window_trace(torch, cfg, params, prompt, steps, device):
    """Greedy chunked prefill (256-row chunks through the ring) + decode
    of one request through forward_paged over the grouped engine's pools
    (every layer sliding: a ring of R pages, no full group); returns
    (tokens [steps + 1], logits [steps + 1, V]) on the host."""
    from simplellminference_tpu_torch.memory.paged_kv import PagedKVCache
    from simplellminference_tpu_torch.models import llama

    ps, r, ln = 128, MISTRAL_RING, len(prompt)
    mp = -(-(ln + steps + 1) // ps)
    cache = PagedKVCache.create(0, 1, cfg.num_kv_heads, ps, cfg.head_dim,
                                torch.float32, device=device).with_windowed(
                                    cfg.num_layers, r)
    tables = (torch.full((1, mp), -1, dtype=torch.int32, device=device),
              (torch.arange(mp, device=device) % r).to(torch.int32)[None])
    ids = torch.tensor(prompt, dtype=torch.int32)
    for off in range(0, ln, MISTRAL_CHUNK):
        chunk = torch.zeros((1, MISTRAL_CHUNK), dtype=torch.int32)
        part = ids[off:off + MISTRAL_CHUNK]
        chunk[0, :len(part)] = part
        pos = off + torch.arange(MISTRAL_CHUNK, dtype=torch.int32,
                                 device=device)[None]
        kv = torch.tensor([min(ln, off + MISTRAL_CHUNK)], dtype=torch.int32,
                          device=device)
        logits, cache = llama.forward_paged(
            cfg, params, chunk.to(device), pos, cache, tables, kv,
            prefill=True, last_token_only=True,
            chunk_offset=torch.tensor([off], dtype=torch.int32,
                                      device=device))
    outs = [logits[0, -1].cpu()]
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    toks = [int(tok[0])]
    pos = torch.tensor([ln], dtype=torch.int32, device=device)
    for _ in range(steps):
        logits, cache = llama.forward_paged(cfg, params, tok[:, None],
                                            pos[:, None], cache, tables,
                                            pos + 1, prefill=False)
        outs.append(logits[0, 0].cpu())
        tok = logits[:, 0].argmax(-1).to(torch.int32)
        toks.append(int(tok[0]))
        pos = pos + 1
    return toks, torch.stack(outs, 0)


def window_card_vs_cpu(torch, launches):
    """Sliding windows card vs CPU at Mistral-7B width (1 layer: Mistral's
    layers all slide, so one layer runs every form a second would; window
    4096, f32, TF32 off): one 4448-token prompt, chunked prefill through
    the ring (R 35), 40 new tokens (kv_len 4487, past the ring's 4480
    tokens): logits of every step within LOGIT_TOL, greedy tokens equal
    (or parting only where the CPU's top-2 margin is below it); and the
    card's grouped Engine (prefill_chunk 256) serving the same prompt to
    the CPU's tokens by the same rule."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig,
                                                          ModelConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.engine import Engine
    from simplellminference_tpu_torch.models import llama

    tag = "mistral-window"
    cfg = ModelConfig.mistral_7b(num_layers=1, sliding_window=WINDOW,
                                 dtype="float32")
    # one draw, on the card (a numpy draw of these 0.7 G values took
    # 14.9 s of the host), copied to the host byte for byte
    t0 = time.perf_counter()
    p_gpu = llama.init_params(cfg, seed=11, device="cuda")
    p_cpu = _to_device(p_gpu, "cpu")
    rng = np.random.default_rng(11)
    prompt, new = rng.integers(1, cfg.vocab_size, 4448).tolist(), 40
    t1 = time.perf_counter()
    tok_c, lg_c = _window_trace(torch, cfg, p_cpu, prompt, new - 1, "cpu")
    t2 = time.perf_counter()
    tok_g, lg_g = _window_trace(torch, cfg, p_gpu, prompt, new - 1, "cuda")
    err = max(max_err(lg_g[t], lg_c[t]) for t in range(new))
    part = next((t for t in range(new) if tok_g[t] != tok_c[t]), None)
    if part is not None:
        # the logits after a parted token follow another context
        err = max(max_err(lg_g[t], lg_c[t]) for t in range(part + 1))
    require(err <= LOGIT_TOL, f"[{tag}] logits differ by {err:.3e}")
    _first_divergence(torch, tag, "greedy traces", tok_g, tok_c,
                      lg_c[:, None], 0)
    # the same prompt through the card's grouped Engine
    ecfg = EngineConfig(max_batch_size=1, prefill_chunk=MISTRAL_CHUNK,
                        kv=KVCacheConfig(page_size=128, num_pages=40,
                                         max_pages_per_seq=38,
                                         kv_dtype="f32"))
    eng = Engine(cfg, p_gpu, ecfg, decode_burst=16, device="cuda")
    require(eng._grouped and eng._ring == MISTRAL_RING,
            f"[{tag}] engine grouped {eng._grouped}, ring {eng._ring}")
    out = eng.generate([prompt], SamplingParams(max_new_tokens=new))[0]
    require(len(out) == new, f"[{tag}] engine gave {len(out)} tokens")
    _first_divergence(torch, tag, "card engine and CPU trace", out, tok_c,
                      lg_c[:, None], 0)
    print(f"[cpu:{tag}] Mistral-7B width, 1 layer, window {WINDOW}, f32, "
          f"TF32 off, grouped pools (R {MISTRAL_RING}): {len(prompt)}-token "
          f"prompt in {MISTRAL_CHUNK}-row chunks + {new} tokens (kv_len "
          f"{len(prompt) + new - 1} > {MISTRAL_RING * 128}); CPU trace "
          f"{t2 - t1:.1f} s (weights drawn in {t1 - t0:.1f} s); logits "
          f"max|card - cpu| {err:.3e} (tol {LOGIT_TOL}); greedy tokens "
          f"equal: trace {tok_g == tok_c}, card engine {out == tok_c}",
          flush=True)
    del p_gpu, p_cpu, eng


def phase_cpu(torch, launches: dict):
    import dataclasses

    import numpy as np

    from simplellminference_tpu_torch.core.config import (ModelConfig,
                                                          QuantConfig)
    from simplellminference_tpu_torch.models import llama
    from simplellminference_tpu_torch.runtime.hf_quant import (
        quantized_params_from_fetcher)
    from simplellminference_tpu_torch.runtime.weights import quantize_params

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    lap = Laps()
    # one layer at Llama-2-7B width, to keep the run within half its time
    # limit: every kernel still runs at the model's shapes
    cfg = ModelConfig.llama2_7b(num_layers=1, dtype="float32")
    rng = np.random.default_rng(7)
    v = cfg.vocab_size
    # one draw of the weights, on the card (the host's numpy draw of these
    # 0.67 G values took ~14 s), copied to the host byte for byte
    p_cpu = _to_device(llama.init_params(cfg, seed=7, device="cuda"), "cpu")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # INT4 (group 128, INT4 head) and INT8 group 128 for W8A8, quantized
    # by the port on the CPU from the same draw, carried to the card
    q4_cpu = quantize_params(p_cpu, QuantConfig(mode="int4", group_size=128,
                                                quantize_lm_head=True))
    q8g_cpu = quantize_params(p_cpu, QuantConfig(mode="int8",
                                                 group_size=128,
                                                 quantize_lm_head=True))
    print(f"[cpu] INT4 and group-128 INT8 quantize_params on the CPU in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = [rng.integers(1, v, ln).tolist() for ln in (40, 64, 17, 50)]
    p_gpu = _to_device(p_cpu, "cuda")
    lap("draw and quantize")
    card_vs_cpu(torch, "bf16-path", cfg, p_gpu, p_cpu, prompts, steps=8)
    prefix_card_vs_cpu(torch, cfg, p_gpu, p_cpu)
    # INT8 KV: the float weights, plain and with the prefix traffic
    card_vs_cpu(torch, "bf16-path-int8kv", cfg, p_gpu, p_cpu, prompts,
                steps=8, kv_dtype="int8")
    prefix_card_vs_cpu(torch, cfg, p_gpu, p_cpu, kv_dtype="int8")
    spec_card_vs_cpu(torch, "spec", cfg, p_gpu, p_cpu)
    dense_card_vs_cpu(torch, "dense-f32", cfg, p_gpu, p_cpu, prompts,
                      steps=8)
    draft_card_vs_cpu(torch, cfg, p_gpu, p_cpu)
    del p_gpu
    lap("llama float weights")
    # INT8: the same draw quantized by the port (per output channel, INT8
    # LM head), on the CPU, then carried to the card byte for byte
    q_cpu = quantize_params(p_cpu, QuantConfig(mode="int8", group_size=0,
                                               quantize_lm_head=True))
    quantize_card_vs_cpu(torch, p_cpu, q_cpu)
    del p_cpu
    q_gpu = _to_device(q_cpu, "cuda")
    card_vs_cpu(torch, "int8", cfg, q_gpu, q_cpu, prompts, steps=8)
    dense_card_vs_cpu(torch, "dense-int8", cfg, q_gpu, q_cpu, prompts,
                      steps=4)
    card_vs_cpu(torch, "int8-int8kv", cfg, q_gpu, q_cpu, prompts, steps=8,
                kv_dtype="int8")
    # FP8 KV: bench.py --kv-dtype fp8's weights and KV
    card_vs_cpu(torch, "int8-fp8kv", cfg, q_gpu, q_cpu, prompts, steps=8,
                kv_dtype="fp8")
    spec_card_vs_cpu(torch, "spec-int8-int8kv", cfg, q_gpu, q_cpu,
                     kv_dtype="int8", new=8)
    del q_gpu, q_cpu
    lap("llama int8 weights")
    # the INT4 and W8A8 checks' prompts: short (the CPU's plain INT4 and
    # W8A8 products are slow at 7B width), W8A8's bucket of 32 giving the
    # 128 prefill rows from which W8A8 applies
    short = [p[:n] for p, n in zip(prompts, (12, 16, 5, 9))]
    w8a8_prompts = [p[:n] for p, n in zip(prompts, (20, 32, 9, 25))]
    # INT4: bench.py --quant int4's kernel on quantize_params' weights
    q4_gpu = _to_device(q4_cpu, "cuda")
    card_vs_cpu(torch, "int4", cfg, q4_gpu, q4_cpu, short, steps=4)
    dense_card_vs_cpu(torch, "dense-int4", cfg, q4_gpu, q4_cpu, short,
                      steps=2)
    del q4_gpu, q4_cpu
    lap("llama int4")
    # AWQ: the zero-point form, params from a seeded in-memory checkpoint
    t0 = time.perf_counter()
    fetch, qcfg = awq_fetcher(cfg, seed=8)
    a_cpu = quantized_params_from_fetcher(cfg, fetch, qcfg, device="cpu")
    del fetch
    print(f"[cpu:awq] the in-memory AWQ checkpoint drawn and imported in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    a_gpu = _to_device(a_cpu, "cuda")
    # the AWQ form's launches: the Engine and the Generator on the card
    # (their CPU halves launch nothing), counted like a path of phase 4
    reset_counts()
    card_vs_cpu(torch, "awq", cfg, a_gpu, a_cpu, short, steps=4)
    awq_bf16(torch, cfg, a_gpu, a_cpu, short)
    launches["awq"] = read_counts("awq")
    require(launches["awq"]["quantized_matmul_int4_zs"] > 0
            and launches["awq"]["quantized_matmul_int4"] == 0,
            f"[awq] INT4 launches {launches['awq']}")
    from simplellminference_tpu_torch.ops import matmul as mm
    if int4_regime_launches(mm):
        require(launches["awq"]["quantized_matmul_int4_mma"] > 0
                and launches["awq"]["quantized_matmul_int4_wgmma"] > 0,
                f"[awq] no tensor-core INT4 launches: {launches['awq']}")
    print(f"[cpu:awq] launches on the card {json.dumps(launches['awq'])}",
          flush=True)
    del a_gpu, a_cpu
    lap("llama awq")
    # W8A8: the server's --act-quant over group-128 INT8 weights
    cfg_aq = dataclasses.replace(cfg, act_quant="int8")
    q8g_gpu = _to_device(q8g_cpu, "cuda")
    counts = getattr(mm, "W8A8_REGIME_LAUNCHES", {})
    before = dict(counts)
    card_vs_cpu(torch, "w8a8", cfg_aq, q8g_gpu, q8g_cpu, w8a8_prompts,
                steps=4)
    prefix_card_vs_cpu(torch, cfg_aq, q8g_gpu, q8g_cpu)
    by_regime = {r: c - before[r] for r, c in counts.items()}
    print(f"[cpu:w8a8] W8A8 launches on the card by regime {by_regime}",
          flush=True)
    del q8g_gpu, q8g_cpu
    lap("llama w8a8")
    window_card_vs_cpu(torch, launches)
    lap("mistral window")
    gemma_card_vs_cpu(torch)
    lap("gemma")
    gemma2_card_vs_cpu(torch, launches)
    lap("gemma2")
    gpt_oss_card_vs_cpu(torch)
    lap("gpt-oss")
    mla_card_vs_cpu(torch, launches)
    lap("mla")
    lap.print("phase-5")


def gemma_card_vs_cpu(torch):
    """Gemma-2B at full width (H 2048, I 16384, V 256000, 8 heads over one
    kv head of 256, GeGLU, the embedding scale, a tied head), 1 layer (its
    layers are alike: no window, no cap),
    f32, TF32 off, from one seeded draw on the card copied to the host:
    the f32 weights and the same draw quantized by the port (INT8 per
    channel; the tied head stays the f32 embedding) through
    :func:`card_vs_cpu` (prefill + 8 greedy steps, logits within
    LOGIT_TOL, greedy tokens equal by the margin rule, the Engine on both
    devices), and the prefix traffic with the f32 weights through
    :func:`prefix_card_vs_cpu`. The card runs the D-256 forms: 3, 4, 8,
    the FMA kernel 6 (f32 rows), 1 and 2."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import (ModelConfig,
                                                          QuantConfig)
    from simplellminference_tpu_torch.models import llama
    from simplellminference_tpu_torch.ops.attention import paged_decode as pd
    from simplellminference_tpu_torch.runtime.weights import quantize_params

    cfg = ModelConfig.gemma_2b(num_layers=1, dtype="float32")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, ln).tolist()
               for ln in (40, 64, 17, 50)]
    t0 = time.perf_counter()
    p_cpu = _to_device(llama.init_params(cfg, seed=11, device="cuda"), "cpu")
    torch.cuda.empty_cache()
    before = pd.D256_LAUNCHES["paged_flash_decode"]
    p_gpu = _to_device(p_cpu, "cuda")
    card_vs_cpu(torch, "gemma-f32", cfg, p_gpu, p_cpu, prompts, steps=8)
    prefix_card_vs_cpu(torch, cfg, p_gpu, p_cpu, tag="gemma-prefix")
    del p_gpu
    q_cpu = quantize_params(p_cpu, QuantConfig(mode="int8", group_size=0))
    del p_cpu
    q_gpu = _to_device(q_cpu, "cuda")
    card_vs_cpu(torch, "gemma-int8", cfg, q_gpu, q_cpu, prompts, steps=8)
    del q_gpu, q_cpu
    torch.cuda.empty_cache()
    ran = pd.D256_LAUNCHES["paged_flash_decode"] - before
    require(ran > 0, "[cpu:gemma] no D-256 decode launch on the card")
    print(f"[cpu:gemma] Gemma-2B card vs CPU (f32, INT8, prefix traffic) in "
          f"{time.perf_counter() - t0:.1f} s; D-256 decode launches on the "
          f"card {ran}", flush=True)


def gemma2_card_vs_cpu(torch, launches: dict):
    """Gemma-2-2B at full width (H 2304, I 9216, V 256000, 8 heads over 4
    kv heads of 256, the soft caps, the sandwich norms, a sliding and a
    full layer), 2 layers, f32, TF32 off, from one seeded draw on the card
    copied to the host (the sandwich norms drawn away from ones, so that a
    dropped norm shows): the f32 weights and the same draw quantized by
    the port (INT8 per channel) through :func:`card_vs_cpu` (prefill + 8
    greedy steps, logits within LOGIT_TOL, greedy tokens equal by the
    margin rule, the grouped Engine on both devices), and the f32 weights
    again over INT8 KV (logits within LOGIT_TOL while both caches hold the
    same codes, else LOGIT_TOL_CODE_APART) and over FP8 KV (the card
    carries on with the CPU's codes, layer 0's at most one e4m3 step
    apart; LOGIT_TOL, or LOGIT_TOL_CODE_APART once a code parts; its
    launches recorded as ``gemma2_fp8kv_cpu``'s). The card runs the capped
    forms 3c, 3wc, 4c and 4wc, over INT8 KV 4qc/256 and 4qwc/256, over FP8
    KV 4ec/256, 4ewc/256, 1e/256 and 2e/256 (and 6k with INT8 weights: f32
    rows take the FMA kernel). Then, the window cut to
    32 so that the prompts
    and the steps pass it, the f32 weights through the Generator
    (:func:`dense_card_vs_cpu`: 13c, 13wc; and over an e4m3 arena,
    :func:`dense_fp8kv_card_vs_cpu`: 12e/256, 13ec/256, 13ewc/256, its
    launches recorded as ``gemma2_dense_fp8kv_cpu``'s), the prompt-lookup
    spec Engine
    (:func:`spec_card_vs_cpu`: 4vc, 4vwc over the ring pools) and, as the
    draft of a Gemma-2-9B-wide target (2 layers, f32, a seeded draw), the
    draft Engine (:func:`draft_card_vs_cpu`: the rollout's 13c/13wc, the
    target's 4vc/4vwc)."""
    import dataclasses

    import numpy as np

    from simplellminference_tpu_torch.core.config import QuantConfig
    from simplellminference_tpu_torch.models import llama
    from simplellminference_tpu_torch.ops.attention import flash_prefill as fp
    from simplellminference_tpu_torch.runtime.weights import quantize_params

    cfg = gemma2_2b(num_layers=2, dtype="float32")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab_size, ln).tolist()
               for ln in (40, 64, 17, 50)]
    t0 = time.perf_counter()
    p_gpu = llama.init_params(cfg, seed=12, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    for name in ("post_attn_norm", "post_ffn_norm"):
        p_gpu["layers"][name] = 1.0 + 0.3 * torch.randn(
            p_gpu["layers"][name].shape, generator=gen, device="cuda")
    p_cpu = _to_device(p_gpu, "cpu")
    before = dict(fp.CAP_LAUNCHES)
    card_vs_cpu(torch, "gemma2-f32", cfg, p_gpu, p_cpu, prompts, steps=8)
    # over INT8 KV: 4qc/256, 4qwc/256 on the card (the grouped engine's
    # INT8 ring pools)
    card_vs_cpu(torch, "gemma2-int8kv", cfg, p_gpu, p_cpu, prompts, steps=8,
                kv_dtype="int8")
    # over FP8 KV: 2e/256, 1e/256 (f32 weights: no fused qkv), 3c/3wc,
    # 4ec/256 and 4ewc/256 on the card (the grouped engine's e4m3 ring
    # pools); its launches counted like a path's
    t1 = time.perf_counter()
    snap = count_snapshot()
    card_vs_cpu(torch, "gemma2-fp8kv", cfg, p_gpu, p_cpu, prompts, steps=8,
                kv_dtype="fp8")
    got = launches["gemma2_fp8kv_cpu"] = counts_since("gemma2_fp8kv_cpu",
                                                      snap)
    rows = ("paged_append_prefill_fp8kv_d256", "paged_append_decode_fp8kv_d256",
            "paged_flash_decode_fp8kv_cap_d256",
            "paged_flash_decode_fp8kv_window_cap_d256")
    require(all(got[row] > 0 for row in rows),
            f"[cpu:gemma2-fp8kv] the FP8-KV forms did not all run on the "
            f"card: { {row: got[row] for row in rows} }")
    print(f"[cpu:gemma2-fp8kv] launches on the card "
          f"{ {k: n for k, n in got.items() if n} }; "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    cfg_w = dataclasses.replace(cfg, sliding_window=32)
    dense_card_vs_cpu(torch, "gemma2-dense", cfg_w, p_gpu, p_cpu, prompts,
                      steps=8)
    # the Generator over an e4m3 arena: 12e/256, 13ec/256, 13ewc/256 on
    # the card (f32 weights: no fused qkv); counted like a path's
    snap = count_snapshot()
    dense_fp8kv_card_vs_cpu(torch, "gemma2-dense-fp8kv", cfg_w, p_gpu, p_cpu,
                            prompts, steps=8)
    got = launches["gemma2_dense_fp8kv_cpu"] = counts_since(
        "gemma2_dense_fp8kv_cpu", snap)
    rows = ("kv_append_fp8kv_d256", "flash_decode_fp8kv_cap_d256",
            "flash_decode_fp8kv_window_cap_d256")
    require(all(got[row] > 0 for row in rows),
            f"[cpu:gemma2-dense-fp8kv] the FP8-KV forms did not all run on "
            f"the card: { {row: got[row] for row in rows} }")
    spec_card_vs_cpu(torch, "gemma2-spec", cfg_w, p_gpu, p_cpu)
    t_cfg = dataclasses.replace(gemma2_9b(num_layers=2, dtype="float32"),
                                sliding_window=32)
    t_gpu = llama.init_params(t_cfg, seed=14, device="cuda")
    t_cpu = _to_device(t_gpu, "cpu")
    draft_card_vs_cpu(torch, t_cfg, t_gpu, t_cpu,
                      draft=(cfg_w, p_gpu, p_cpu), tag="gemma2-draft")
    del t_gpu, t_cpu, p_gpu
    q_cpu = quantize_params(p_cpu, QuantConfig(mode="int8", group_size=0))
    del p_cpu
    q_gpu = _to_device(q_cpu, "cuda")
    card_vs_cpu(torch, "gemma2-int8", cfg, q_gpu, q_cpu, prompts, steps=8)
    del q_gpu, q_cpu
    torch.cuda.empty_cache()
    ran = {f"{form}/{d}": n - before.get((form, d), 0)
           for (form, d), n in fp.CAP_LAUNCHES.items()}
    require(all(ran.get(f"{form}/256", 0) > 0 for form in (
        "flash_prefill", "flash_prefill_window", "paged_flash_decode",
        "paged_flash_decode_window", "flash_decode", "flash_decode_window",
        "paged_flash_verify", "paged_flash_verify_window",
        "paged_flash_decode_int8kv", "paged_flash_decode_int8kv_window")),
        f"[cpu:gemma2] the capped forms did not all run on the card: {ran}")
    print(f"[cpu:gemma2] Gemma-2-2B card vs CPU (f32, INT8; the Generator, "
          f"the spec and the draft Engines) in "
          f"{time.perf_counter() - t0:.1f} s; capped launches on the card "
          f"{ran}", flush=True)


def gpt_oss_card_vs_cpu(torch):
    """gpt-oss-20b at full width (H 2880, 32 experts of 2880 with top 4
    and their biases, V 201088, 64 heads over 8 kv heads of 64, sinks,
    q/k/v/o biases, yarn rotary), 2 layers (one sliding, one full), f32,
    TF32 off, from one seeded draw on the card copied to the host (13 GB),
    the window cut to 32 so that the prompts and the steps pass it:
    :func:`card_vs_cpu` (prefill + 8 greedy steps, logits within
    LOGIT_TOL, greedy tokens equal by the margin rule, the grouped Engine
    on both devices), again over INT8 KV (LOGIT_TOL while both caches hold
    the same codes, else LOGIT_TOL_CODE_APART), and the prefix traffic
    through
    :func:`prefix_card_vs_cpu` (chunked prefill over the ring pools), the
    Generator (:func:`dense_card_vs_cpu`: the dense forward's logits within
    LOGIT_TOL over the prefill and 4 steps, ``generate`` and
    ``generate_fused`` greedy tokens equal) and the prompt-lookup spec
    Engine (:func:`spec_card_vs_cpu`: spec_tokens 4 over the ring pools,
    8 new tokens, greedy tokens equal card vs CPU, to spec_tokens=0's and
    to the greedy trace by the margin rule), and :func:`card_vs_cpu` over
    FP8 KV (the card carries on with the CPU's codes, layer 0's at most one
    step apart; LOGIT_TOL, or LOGIT_TOL_CODE_APART once a code parts). The
    card runs the sink forms 3s, 3ws, 4s, 4ws, 8s, 8ws, 4vs, 4vws, 13s and
    13ws, 4qs and 4qws over INT8 KV and 4es and 4ews over FP8 KV, in f32,
    the folded
    experts at decode and the grouped ones at prefill and on verify
    rows."""
    import dataclasses

    import numpy as np

    from simplellminference_tpu_torch.models import llama
    from simplellminference_tpu_torch.ops.attention import flash_prefill as fp

    cfg = dataclasses.replace(gpt_oss_20b(num_layers=2, dtype="float32"),
                              sliding_window=32)
    rng = np.random.default_rng(20)
    prompts = [rng.integers(1, cfg.vocab_size, ln).tolist()
               for ln in (40, 64, 17, 50)]
    t0 = time.perf_counter()
    lap = Laps()
    p_gpu = llama.init_params(cfg, seed=20, device="cuda")
    p_cpu = _to_device(p_gpu, "cpu")
    before = dict(fp.SINK_LAUNCHES)
    lap("draw")
    card_vs_cpu(torch, "gpt-oss-f32", cfg, p_gpu, p_cpu, prompts, steps=8)
    lap("f32")
    # over INT8 KV: 4qs, 4qws on the card (the INT8 ring pools)
    card_vs_cpu(torch, "gpt-oss-int8kv", cfg, p_gpu, p_cpu, prompts,
                steps=8, kv_dtype="int8")
    lap("int8kv")
    # over FP8 KV: 4es, 4ews on the card (the e4m3 ring pools), the same
    # draw on both devices
    card_vs_cpu(torch, "gpt-oss-fp8kv", cfg, p_gpu, p_cpu, prompts,
                steps=8, kv_dtype="fp8")
    lap("fp8kv")
    prefix_card_vs_cpu(torch, cfg, p_gpu, p_cpu, tag="gpt-oss-prefix")
    lap("prefix")
    dense_card_vs_cpu(torch, "gpt-oss-dense", cfg, p_gpu, p_cpu, prompts,
                      steps=4)
    lap("dense")
    spec_card_vs_cpu(torch, "gpt-oss-spec", cfg, p_gpu, p_cpu, new=8)
    lap("spec")
    lap.print("gpt-oss card-vs-CPU")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    ran = {f"{form}/{d}": n - before.get((form, d), 0)
           for (form, d), n in fp.SINK_LAUNCHES.items()}
    require(all(ran.get(f"{form}/64", 0) > 0 for form in (
        "flash_prefill", "flash_prefill_window", "paged_flash_decode",
        "paged_flash_decode_window", "paged_flash_prefill",
        "paged_flash_prefill_window", "paged_flash_verify",
        "paged_flash_verify_window", "flash_decode", "flash_decode_window",
        "paged_flash_decode_int8kv", "paged_flash_decode_int8kv_window",
        "paged_flash_decode_fp8kv", "paged_flash_decode_fp8kv_window")),
        f"[cpu:gpt-oss] the sink forms did not all run on the card: {ran}")
    print(f"[cpu:gpt-oss] gpt-oss-20b card vs CPU (f32; the Engine, the "
          f"prefix traffic, the Generator and the spec Engine) in "
          f"{time.perf_counter() - t0:.1f} s; sink launches on the card "
          f"{ran}", flush=True)


def mla_card_vs_cpu(torch, launches: dict):
    """bench_mla.py's widths (DeepSeek-V2-Lite's attention: H 2048, 16
    heads, kv_lora_rank 512, rope 64, V 8192, a dense FFN of 5632) at 1
    layer, f32, TF32 off, one seeded draw on the card copied to the host,
    in both cache modes: :func:`card_vs_cpu` absorbed (the whole-prompt
    prefill on 3l/640 (the prompts fit one chunk), 8 greedy steps on 4l
    and 1l, the Engine on both devices; logits within LOGIT_TOL, greedy
    tokens equal by the margin rule) and naive (the D-256 forms), the
    prefix traffic absorbed (:func:`prefix_card_vs_cpu`: chunks and
    suffixes through 8l and 2l), and absorbed against naive on the card
    (the Engine's greedy tokens equal, but where the card's own absorbed
    trace puts the top two within LOGIT_TOL). Its launches on the card
    count as `mla_cpu`'s: every shared-KV form must have run."""
    import numpy as np

    from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                          KVCacheConfig,
                                                          SamplingParams)
    from simplellminference_tpu_torch.engine import Engine
    from simplellminference_tpu_torch.models import llama

    t0 = time.perf_counter()
    lap = Laps()
    snap = count_snapshot()
    cfg_a = mla_config(1, dtype="float32")
    cfg_n = mla_config(1, dtype="float32", absorbed=False)
    rng = np.random.default_rng(26)
    prompts = [rng.integers(1, cfg_a.vocab_size, ln).tolist()
               for ln in (40, 64, 17, 50)]
    p_gpu = llama.init_params(cfg_a, seed=26, device="cuda")
    p_cpu = _to_device(p_gpu, "cpu")
    lap("draw")
    card_vs_cpu(torch, "mla-absorbed", cfg_a, p_gpu, p_cpu, prompts, steps=8)
    lap("absorbed")
    prefix_card_vs_cpu(torch, cfg_a, p_gpu, p_cpu, tag="mla-prefix")
    lap("prefix")
    card_vs_cpu(torch, "mla-naive", cfg_n, p_gpu, p_cpu, prompts, steps=8)
    lap("naive")
    # absorbed against naive on the card, the Engine's greedy tokens
    _tok, lg_a, _codes = _trace(torch, cfg_a, p_gpu, prompts, 8, "cuda")
    ecfg = EngineConfig(max_batch_size=len(prompts), prefix_cache_entries=0,
                        kv=KVCacheConfig(page_size=16, num_pages=64,
                                         max_pages_per_seq=8,
                                         kv_dtype="f32"))
    outs = {}
    for name, cfg in (("absorbed", cfg_a), ("naive", cfg_n)):
        eng = Engine(cfg, p_gpu, ecfg, decode_burst=4)
        require((eng.cache.v is None) == cfg.mla_absorbed,
                f"[mla] {name}: cache.v is None {eng.cache.v is None}")
        outs[name] = eng.generate(prompts,
                                  SamplingParams(max_new_tokens=9))
    for r in range(len(prompts)):
        _first_divergence(torch, "mla", "absorbed and naive on the card",
                          outs["absorbed"][r], outs["naive"][r], lg_a.cpu(),
                          r)
    lap("absorbed vs naive")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    got = launches["mla_cpu"] = counts_since("mla_cpu", snap)
    forms = ("flash_prefill_shared", "paged_flash_decode_shared",
             "paged_flash_prefill_shared", "paged_append_decode_shared",
             "paged_append_prefill_shared", "flash_prefill_d256",
             "paged_flash_decode_d256")
    require(all(got[f] > 0 for f in forms),
            f"[cpu:mla] forms that did not run on the card: "
            f"{[f for f in forms if not got[f]]}")
    lap.print("mla card-vs-CPU")
    print(f"[cpu:mla] absorbed == naive on the card: "
          f"{outs['absorbed'] == outs['naive']}; bench_mla.py's widths "
          f"card vs CPU in {time.perf_counter() - t0:.1f} s; launches on the "
          f"card {json.dumps({k: v for k, v in got.items() if v})}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="the engine phase's paths: a comma-separated "
                         "subset of " + ",".join(PATHS))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    paths = [p for p in PATHS if p in args.paths.split(",")]
    full_run = phases >= set(PHASES) and paths == list(PATHS)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    sass = None
    t_start = time.perf_counter()
    try:
        name, count, _smi = phase_device(torch)
        if not (ROOT / "simplellminference_tpu_torch").is_dir():
            raise SmokeFailure("run from the root of a repository checkout")
        sys.path.insert(0, str(ROOT))
        results: dict = {}
        launches: dict = {}
        took = {}
        for phase, run in (("build", phase_build),
                           ("kernels", lambda: phase_kernels(torch, results)),
                           ("engine", lambda: phase_engine(torch, launches,
                                                           paths)),
                           ("cpu", lambda: phase_cpu(torch, launches))):
            if phase in phases or phase == "build":
                t0 = time.perf_counter()
                out = run()
                took[phase] = round(time.perf_counter() - t0, 1)
                if phase == "build":
                    sass = out
        # the build's SASS counts, disassembled while the phases ran
        t0 = time.perf_counter()
        sass.print()
        sass = None
        took["sass wait"] = round(time.perf_counter() - t0, 1)
        took["outside the phases"] = round(
            time.perf_counter() - t_start - sum(took.values()), 1)
        print(f"[timing] seconds per phase {json.dumps(took)}", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if sass is not None:
            sass.stop()
    if not full_run:
        print(f"chip_smoke: ran only {sorted(phases)} (paths {paths}); the "
              f"result lines come from a run of every phase and path",
              flush=True)
        return 0
    rows = []
    for kname, meta in KERNELS.items():
        r = results.get(kname, {})
        by_path = {p: counts[kname] for p, counts in launches.items()}
        rows.append({"name": kname, "route": "cuda", **meta,
                     "status": "ported", "checked": bool(r),
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "launches_phase3": phase3_launches.get(kname, 0),
                     "library": LIBRARY[kname],
                     "max_abs_err": r.get("max_abs_err"),
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by"),
                     "library_ms": r.get("library_ms"),
                     "cold_ms": r.get("cold_ms")})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
