#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device; it exits non-zero and prints no result without
one, or when run outside the repository (it imports the port from
``src/``).  It imports neither jax nor the JAX package.  Phases, each
printed as JSON lines:

  1. device   — ``nvidia-smi`` name and power limit of card 0.  The CUDA
     C++ kernels, echo-aggregate (K1-K3), flash attention (K4) and the
     SSD chunk (K5: its tensor-core kernel and its FP32-pipe kernel),
     start building together, one nvcc each in its own thread, from
     ``src/repro_torch/kernels/*/csrc`` into ``build/kernels``.
  2. kernels  — K1-K3's kernel (``csrc/echo_aggregate.cu``; ptxas's report,
     its dynamic shared memory and its global loads by width in the SASS
     printed): each case called twice through the checked wrappers (one
     launch each, equal bits), held against the plain torch version on
     the same inputs, 1e-5 for float32 and 5e-2 for bfloat16
     (tests/test_kernels.py's bounds), and up to 128 rows bit-equal to
     ``echo_aggregate_split_ref``, the kernel's own arithmetic in plain
     torch; an all-zero mask must return the previous global exactly.
     Variants: K1 the fused FedAWE update, K2 with non-binary upload
     weights, K3 without the empty-round guard; ``ECHO_CASES`` lists the
     shapes (N odd, stacks off a 16-byte boundary, m = 1, m = 7 at 8
     forced slices, the tall m = 16 384, the cohort's [256, 27 370]).
     Then the kernel's seed axis
     (``SEED_CASES``: [4, 100, 27 370] and [3, 1 024, 4 099], float32 and
     bfloat16, K1, K2 and K3 in one launch each): every seed's output
     bit-equal to a launch on that seed alone at the same slice count and
     to ``echo_aggregate_split_ref``, within 1e-5 / 5e-2 of the plain
     version, and with the guard an all-zero mask in seed 1 returning
     seed 1's global exactly while the others aggregate.  Then K1 and K2
     through the tree route (``ops.echo_aggregate_tree``) on the
     full-width CNN's 8 leaves at [100, 27 370]: one launch a call, equal
     bits twice, bit-equal to the flat wrapper on the raveled stacks,
     within 1e-5 of the route's plain version and within 1e-4 of FedAWE's
     per-leaf plain tree update.  Then K4
     (ptxas's registers, spills and remarks per instantiation printed,
     and the bf16 kernel's dynamic
     shared memory) against its plain version in float32 and bfloat16:
     the six cases of tests/test_kernels.py:84-91, the window's lower
     edge, the dtype case of :108, head dim 256 (the main path's build)
     at short lengths where the outputs are O(1), gemma2-2b's attention
     (B 2, H 8, K 4, L = S = 8192, D 256, soft-cap 50) windowed (4096)
     and global, and a suffix (L 1024, S 8192), within 1e-4 (float32)
     and 3e-2 (bfloat16), and every output row within 1e-4 / 2e-2 of its
     own largest element (rows that average thousands of keys have
     outputs near 0.03); zamba2-7b's attention (head dim 112, 32 heads,
     global) at full length on one batch row and 8 heads, and at 256
     tokens on all; ragged shapes (L and S off the tiles, head dim 112
     with GQA and a window, suffixes, head dim 16, head dim 128 with GQA,
     a window and a soft-cap); head dim 128 at full length, where the
     products run over all 128 dims: olmoe-1b-7b's attention (B 2, H 16,
     K 16, L = S = 8192, global; moonshot-v1-16b-a3b's too) and
     mixtral-8x22b's on one batch row (H 48, K 8, window 4096); the
     enc-dec and frontend decoders' self-attention in full:
     seamless-m4t-large-v2's (B 2, H 16, K 16, L = S = 8192, head dim
     64, global) and internvl2-2b's (H 16 over K 8, head dim 128);
     gemma3-27b's (B 2, H 32 over K 16, L = S = 8192, head dim 128)
     windowed (1 024) and global, its plain version a batch row at a time
     (``plain_flash``: 17 GB of float32 scores whole).  In
     bfloat16, up to
     1 024 queries, the same bounds also against ``flash_mha_tiled_ref``,
     the kernel's own tile-by-tile algorithm in plain torch.  Then K5
     (ptxas's report printed for both kernels, and the tensor-core
     kernel's dynamic shared memory) against its plain version in float32
     and bfloat16 at tests/test_kernel_ssd.py's shapes, K = 1, zamba2-7b's
     (B 2, L 8192, H 112, P 64, N 64) and mamba2-130m's (H 24, N 128), on
     the strided views and the stride-0 group expansion the model hands
     it, and at the tensor-core kernel's edges (``SSD_EDGE``: K 64 and 96,
     P 40, N 24 and 128, B and C with a nonzero head stride, dA partly
     positive): every y_diag row within 1e-5 (float32 inputs) or 1e-2
     (bfloat16, one ulp) of its largest element, every states row within
     1e-5, the decay within 1e-6 relative; each line names the route
     ``ops.wgmma_route`` chose, and the bfloat16 cases are held to the
     same bounds against ``ssd_chunk_tiled_ref``, the tensor-core
     kernel's arithmetic in plain torch.  Then K1 / K2's partial form
     and its finalize (``PARTIAL_CASES``: ECHO_CASES' shapes cut into two
     and three row blocks, one block empty, one with an all-zero mask;
     [4, 100, 27 370] on the seed axis; the LM stack [8, 128 983 488] in
     two blocks of 4): the blocks' [N + 1] partials (the column sums,
     then the weight sum) summed and finalized within 1e-5 of the fused
     K1 on the whole stack, in float32 and bfloat16 alike, each partial
     within 1e-5 of its largest value of its plain version (sums that
     cancel; the absolute error beside it) and the finalize bit-equal to
     its plain version; one counted launch per non-empty block and per
     finalize.
  3. main paths, each with every launch count set to 0 just before it
     and read just after:
     a. FL training — ``repro_torch.launch.train`` in-process with
        ``--strategy fedawe --dynamics sine --flat-state --use-kernel
        --chunk-rounds 16 --rounds 64 --m 100 --s 5 --batch 32`` on the
        full-width CNN (N = 27 370): K1 must launch once per round and
        every loss be finite.  The same flags without ``--use-kernel``
        must give identical ``n_active`` histories and a final global
        within 1e-4.
     b. LM serving — gemma2-2b at its published widths in bfloat16 with
        ``attn_backend="flash"``, random weights from a seed: ``prefill``
        of B = 2 prompts of 8192 tokens into a cache of 8192 + 16, then 16
        greedy ``serve_step``s.  K4 must launch exactly 26 times (once
        per layer) in the prefill and never in decode; every logit
        finite.
     c. flash against xla.  The drift witness: reduced gemma2-2b at
        head dim 256 in bfloat16 on weights and tokens drawn with numpy,
        which the JAX package builds too; each layer's attention output
        (kernel against xla branch on the same input, inside the
        model's own layer loop) and the prefill's logits and caches
        within 4x the reference's own flash-vs-xla drift there
        (REF_DRIFT, recomputed on the CPU by
        tests/test_torch_bf16_drift.py).  At full width: in bfloat16
        (B 2) each layer's attention output within 5e-2, printed beside
        its largest output; in float32 (B 1, the bf16 weights upcast)
        logits and cache contents within 1e-3 — 26 layers of reordered
        sums, where the reference's own flash-vs-xla test allows 2e-4 at
        4 layers; the bfloat16 prefills' distance from the float32 one,
        the kernel's within 1.5x the xla branch's.  Small: reduced
        gemma2-2b prefill then decode against the full forward within
        1e-3.
     d. Mamba2 serving — zamba2-7b at its published widths and depth in
        bfloat16 with ``attn_backend="flash"``, random weights from a
        seed: ``prefill`` of B = 2 prompts of 8192 tokens into a cache of
        8192 + 16, then 16 greedy ``serve_step``s.  K5 must launch
        exactly 68 times (once per Mamba2 layer), all on the tensor-core
        kernel, and K4 13 times (once
        per shared-attention invocation) in the prefill, neither in
        decode; every logit finite.  Then the SSD kernel route against
        the plain route inside the model's own layer loop: in bfloat16
        (B 2) each layer's SSD output within 4x the reference's own
        spread between its jnp scan and its drop-in (REF_SSD_DRIFT,
        recomputed on the CPU by tests/test_torch_ssd_chunk.py), as a
        share of the layer's largest output; in float32 (B 1, the bf16
        weights upcast) logits and caches within 1e-3.  Small: reduced
        zamba2-7b prefill then decode against the full forward within
        1e-3.
     e. FL training under faults and staleness — ``train.run`` with the
        FL flags plus ``--use-kernel --midround-drop 0.3 --sanitize
        --stale-max 4 --stale-kind geom --stale-p 0.5 --stale-gamma 0.7``:
        K2 must launch once per round (64) and no other kernel, every
        loss be finite.  The same flags without ``--use-kernel`` must give
        identical ``n_active``, ``n_dropped``, ``n_rejected`` and
        ``n_stale`` histories, ``mean_staleness`` within 1e-6 and a final
        global within 1e-4; sum(n_active) == sum(n_stale) + the updates
        still pending in the ring (geometric delays are >= 1).  Every
        update dropped (``--midround-drop 1.0 --sanitize``, synchronous):
        64 K2 launches, n_dropped == n_active every round, the final
        global bit-equal to the initial one.  The NaN witness: one
        client's images NaN in the device store, an all-ones trace
        (``FaultCfg(trace=True, sanitize=True)``), 4 chunked rounds with
        the kernel: n_rejected == 1 every round and the global finite;
        without sanitization (the negative control) the global is not.
     f. The ten strategies — ``train.run`` with the FL flags, 16 rounds
        and ``--use-kernel`` for each of fedawe, fedawe_m, the three
        FedAvg variants, fedau, f3ast, mifa, fedvarp and fedar: K1 16
        times for fedawe and fedawe_m and no launch for the eight
        baselines, every loss finite, the same ``n_active`` history for
        all ten, no client stack for a stateless strategy, the [100,
        27 370] memory of mifa, fedvarp and fedar finite, and each run's
        peak allocated memory.  fedau, mifa, fedvarp and fedar under the
        fault flags: no launch, finite, sum(n_active) == sum(n_stale) +
        pending.  ``--sampling epoch`` for fedawe and mifa, chunked and
        in the host loop: equal ``n_active`` histories, τ, key and
        sampler carry bit-equal, globals within 1e-4.  fedvarp under
        epoch sampling, 32 rounds through ``--resume P --ckpt-every 16``,
        straight and stopped at 16 then restarted: the restored
        artifacts' τ, key and carry bit-equal, globals within 1e-4.
     g. The seed-batched executor and the grid, at the FL path's size
        (m = 100, s = 5, batch 32, 20 000 samples, the full-width CNN):
        ``experiments.run_scenario("fedawe/sine")`` with 4 seeds, 16
        rounds, K = 16 and the kernel: K1 16 times (once a round for all
        four seeds), every loss finite, no ``torch.func.vmap`` slow-path
        warning; the same seeds through the executor against four
        single-seed runs driven by fold_in(rng, j) / fold_in(data_key,
        j): n_active histories, τ, key and sampler carry bit-equal,
        globals within 1e-4, then one seed chunk under
        ``set_sync_debug_mode("error")``.  ``fedawe/stale_d2+midround``
        with 4 seeds through ``run_multi_seed``: K2 16 times, and seed by
        seed sum(n_active) == sum(n_stale) + pending.  The packed
        speedup-sine grid (7 cells, 4 seeds, 16 rounds): K1 16 times in
        each of the fedawe and fedawe_m cells and never in the five
        others, every cell's histories equal to its unpacked
        ``run_scenario`` (losses within 1e-4).
     h. The sparse cohort round: FedAWE with the kernel at m = 100 000
        clients (``contiguous_client_index``, 8 of 800 000 synthetic
        8x8x1 images each), sine availability around p = 0.002, s = 5,
        batch 32, ``sparse_cohort=256`` over a bfloat16 [m, N] client
        stack (5.47 GB), 32 rounds in chunks of 8 through
        ``make_round_fn`` and ``make_chunk_fn``: K1 once a round on the
        [256, 27 370] working set, every loss finite, the rows of clients
        that never computed bit-unchanged, each chunk's peak allocated
        memory above the resident state below one bfloat16 [m, N] stack;
        the same run without the kernel with n_active and n_deferred
        bit-equal, τ equal and the global within 1e-4.  MIFA 8 rounds at
        the same size (its memory a second bfloat16 [m, N] stack): no
        launch, finite.  ms per round by chunk, a profiler breakdown of
        a 4-round chunk and K1 alone at [256, 27 370] float32 against its
        16.8 µs bound.  At m = 100 through ``train.run`` (24 rounds, K =
        16): ``--sparse-cohort 100`` against the dense run, with the
        kernel, fault-free and under the fault and stale flags: counts,
        τ and keys bit-equal, launches equal, globals within 1e-4;
        bfloat16 residency within 2e-2 of float32.  ``train --seeds 4
        --sparse-cohort 32``: K1 16 times (once a round for all seeds, on
        [4, 32, 27 370]), every loss finite; each seed through the
        executor bit-equal to its single-seed cohort run (n_active,
        n_deferred, τ, key, carry), globals within 1e-4.
     i. The tree-state round, the JAX package's default substrate:
        ``train.run`` with the FL flags without ``--flat-state``, with the
        kernel: K1 64 times in 64 rounds, each on [100, 27 370] (the CNN's
        8 leaves raveled), against phase a's flat run n_active,
        mean_echo, τ and key bit-equal, the raveled global within 1e-4;
        the same under ``--midround-drop 0.3 --sanitize`` against the flat
        run of those flags, K2 64 times.  The ten strategies on tree state
        for one 16-round chunk each: K1 only for fedawe and fedawe_m,
        every loss finite, every strategy a client tree, a memory
        strategy's memory a tree; one FedAWE tree chunk under
        ``set_sync_debug_mode("error")``.  ``--seeds 4`` on tree state: K1
        once a round for all seeds on [4, 100, 27 370], each seed's
        n_active, τ and key bit-equal to its single-seed tree run.  The
        paper harness's linear model (benchmarks/common.py, N = 650) at m
        = 32 built from the engine, with both TF32 flags set first: the
        engine-built CUDA state turns both off; K1 once a round on
        [32, 650], held against the run without the kernel.
     j. MoE serving, run after phase 4's gemma2-2b and zamba2-7b timings
        have freed those models' weights, with its own numbers.
        olmoe-1b-7b at its published widths and depth (16 layers,
        d_model 2048, 16 heads of 128, 64 experts top-8 of width 1024,
        vocab 50 304; 6.92 B parameters) in bfloat16 with
        ``attn_backend="flash"``, random weights from a seed: the LM
        path's prefill and 16 greedy steps; K4 16 times in the prefill
        (once per layer), never in decode; every logit finite.  A second
        prefill bit-equal (logits, and the cache over the prompt's
        slots), each layer's share of dropped slots at cf 1.25 printed.
        Prefill ms, decode ms per step and a profiler breakdown by part
        (K4, cuBLAS, the router, the dispatch's sort, gathers and
        scatters, the rest).  In float32 (B 1, the bf16 weights
        upcast): inside the model's own layer loop each layer's
        ``moe_ffn`` at cf = E against ``moe_ffn_dense_ref`` on the same
        input, and at cf 1.25 every token whose k slots were all kept,
        within 2e-4 (tests/test_moe.py:28) of the layer's largest dense
        output, on a 2048-token prompt; the flash prefill against the
        xla branch's with the xla run's routing pinned to the flash
        run's experts (a router is discontinuous: unpinned, a near tie
        that the branches' 1e-5 attention differences tip sends a token
        to other experts, and the change spreads): each layer's
        attention output on the same input, the logits and every cache
        leaf within 1e-3, and every token whose own top-k set differs
        from the pinned one a near tie of its router (ROUTE_TIE).
        moonshot-v1-16b-a3b at its published widths and depth (48
        layers, 64 experts top-6 of width 1408 and 2 shared experts,
        vocab 163 840; 28.89 B parameters, 57.8 GB) the same way: K4 48
        times in the prefill, 0 in decode, finite logits, its memory and
        times.  Small: reduced olmoe-1b-7b, moonshot-v1-16b-a3b and
        mixtral-8x22b (fl_mode "full"; cf = E) prefill then decode
        against the full forward within 1e-3; ``launch.serve``'s CLI on
        the reduced olmoe-1b-7b and moonshot-v1-16b-a3b finishes its
        requests.
     k. Encoder-decoder and frontend serving, run after phase 3j, with
        its own numbers.  seamless-m4t-large-v2 (12 encoder and 12
        decoder layers, d_model 1024, 16 heads of 64, d_ff 8192, vocab
        256 206 tied; 1.02 B parameters) and then internvl2-2b (24
        layers, d_model 2048, 16 query over 8 kv heads of 128, vocab
        92 553; 1.89 B) at their published widths and depth in bfloat16
        with ``attn_backend="flash"``, random weights from a seed, and
        the stub frontends' outputs drawn from a seed: seamless's
        ``enc_embeds`` [2, 1536, 1024] (audio frames), internvl2's
        ``embeds`` [2, 1024, 2048] in place of the first 1 024 token
        embeddings.  The LM path's prefill and 16 greedy steps: K4 once
        per decoder layer in the prefill (12 and 24), never in decode
        (the encoder and the cross-attention take the plain attention);
        every logit finite; a second prefill bit-equal (logits, the
        cache over the prompt's slots, the encoder output).  Prefill ms,
        decode ms per step, a profiler breakdown by part (K4, cuBLAS,
        the encoder's attention, the cross-attention, the rest) and the
        encoder's ms.  In float32 (B 1, weights and inputs upcast): the
        flash prefill against the xla branch's, each layer's attention
        sub-block on the same input, the logits and every cache leaf
        (the encoder output included) within 1e-3.  Small: the reduced
        models prefill then decode against the full forward within
        1e-3; ``launch.serve``'s CLI finishes its requests on both.
     l. Full-parameter federated LM training, run after phase 3k, with
        its own numbers.  ``train --preset lm`` (fl-lm-tiny on the
        synthetic token streams, FedAWE, m 6, s 2, batch 8, 8 rounds in
        chunks of 4) on the flat state with the kernel: K1 8 times and
        nothing else; with ``--midround-drop 0.3``: K2 8 times; each
        against the same seed on tree state with the kernel and on the
        flat state without it, per-round metrics and the final eval
        loss within 1e-4.  mamba2-130m at its published widths and
        depth (24 layers, d_model 768, vocab 50 280; 1.29e8 parameters)
        in bfloat16 with remat, random weights from a seed, trained with
        full parameters by FedAWE on the flat [8, N] float32 state with
        K1, built from the engine as tests/test_archs.py builds its
        round (``lm_loss`` over ``merge_trainable``; m 8 at p 0.8, s 2,
        eta_l 0.01), batches of 2 sequences of 1 024 synthetic tokens
        per client and step (uniform over the vocabulary, drawn with
        numpy from a seed): round 1 alone, after which every trainable
        leaf of the global has moved (a weight cut off from the loss,
        such as one behind a detached SSD scan, would not); then 4 rounds
        in one chunk between CUDA events, K1 4 times and K5 never
        (training runs the plain SSD scan), every loss finite, peak
        allocated memory; one profiled round (busy share, launches,
        parts).  K1 alone at [8, N] float32 against its plain version
        (1e-5), timed beside it and its bound.  Every fl_mode="full"
        architecture of the registry at ``reduced()``, in its own
        ``fl_mode`` (gemma3-27b and mixtral-8x22b train their adapters
        over a frozen base): one FedAWE round on the card (K1 once)
        against the same round on the CPU port, loss and global within
        1e-4.
     m. LoRA at full width, run after phase 3l, with its own numbers.
        gemma3-27b at its published widths and depth (62 layers, d_model
        5 376, 32 query over 16 kv heads of 128, 1 024-token windows on
        52 layers, vocab 262 144 tied, logit soft-cap 30; 27.04 B
        parameters, 33.5 M of them rank-16 adapters) in bfloat16 with
        ``attn_backend="flash"``: one base from a seed (``init_params``),
        the adapters' ``b_*`` drawn from a second seed at 0.02.  Serving:
        the LM path's prefill and 16 greedy steps, K4 62 times in the
        prefill (52 windowed) and never in decode, every logit finite;
        the last-token logits against the same prefill with the adapters
        zeroed, which must differ (the adapters apply); each layer's
        flash attention against the xla branch's on the same input in
        bfloat16 within 5e-2; prefill ms, decode ms per step and a
        profile by part.  Training on the same weights: FedAWE over the
        frozen base, the adapters on the flat [4, N] float32 state with
        K1, through ``make_round_fn_with_frozen`` and ``make_chunk_fn(...,
        with_frozen=True)`` (m 4 at p 0.8, s 2, one sequence of 1 024
        synthetic tokens per client and step; 2 048 ran out of memory):
        round 1 alone, after which every adapter leaf of the global has
        moved and every base leaf's float64 sum is bit-equal, no base
        leaf requiring a gradient; then
        2 rounds in one chunk between CUDA events, K1 twice and K2-K5
        never, every loss finite, peak allocated memory; one profiled
        round.  The weights freed, K1 alone at [4, N] float32 against its
        plain version (1e-5), timed beside it and its bound.
     n. The example scripts, the seed mesh and the kernel-library cache,
        run after phase 3m.  The four scripts of ``examples/torch`` at
        short lengths through their ``main`` (quickstart's FedAWE bias
        below FedAvg's, federated_lm's loss falling, federated_image's
        finals and files, serve_demo's requests), none launching a
        kernel.  The grid's seed mesh: fedawe/sine with K1, 4 seeds over
        ``make_seed_mesh(4, devices=[cuda:0, cuda:0])`` (two shards of
        two seeds) through ``run_multi_seed``, K1 twice a round where the
        unsplit 4-seed chunk, run just before, launches it once; counts,
        τ, keys and markov bit-equal to it, losses and states within
        1e-6.  The kernel-library cache: ``train --use-kernel
        --compile-cache build/compile_cache_smoke`` in its own process,
        the cold run (the directory emptied) started in phase 1 beside
        the builds and read after phase 2 (nvcc ran: misses >= 1, no
        hit), the warm run here (hits >= 1, no miss, the same final
        eval), each with its seconds.  Beside every prefill and LM round
        the script times (phases 3j-3m and 4), a ``model_flops_share`` line:
        ``analysis.model_flops`` over the time times the bf16 peak.
     o. The placed FL path, run after phase 3n: fedawe/sine and
        fedawe/stale_d2+midround at the FL path's size (m 100, s 5, batch
        32, the full-width CNN), 2 seeds, 16 rounds in chunks of 8, with
        the kernel, through ``run_multi_seed`` as ``run_scenario`` drives
        it: unplaced in this process (the fused K1 / K2 once a round for
        both seeds), then over four ranks spawned on card 0 (gloo through
        a ``FileStore``: NCCL refuses two ranks on one card), a (2, 1, 2)
        ('seed', 'pod', 'data') mesh, each rank building and holding 50
        clients of one seed only (its client stack [1, 50, N], its store
        rows; each run's peak of allocated card memory beside the
        unplaced run's); each rank's counts from 0 just before each run:
        K1's (K2's under the fault cell) partial form and the finalize
        once a round, the fused kernel never; the histories' counts, and
        the final states gathered whole after the run, τ, keys, t, markov
        and ring ages bit-equal to the unplaced run's, losses, globals
        and client stacks within 1e-5, evals within 2 of 1 024; the wall
        time of the placed and the unplaced run in turns.
     p. The dry run's counters against real runs, after phase 3o.
        gemma2-2b's prefill at its published widths (bfloat16, K4, B 2,
        prompt and cache 8 192) once on the card under
        ``analysis.CollectiveCounter`` and once over fake CUDA tensors
        (``FakeTensorMode``, as ``launch/dryrun.py`` runs its steps: no
        card memory, no kernel): flops and bytes accessed equal, K4 26
        times in the real run and never in the fake one, no collective,
        the fake run's counted temp peak within 0.98-1.02 of the card's
        allocated peak above the arguments; the counted flops beside
        ``analysis.model_flops``.  A third placed fedawe/sine run of
        phase 3o's ranks, after the timing turns, counted on rank 0: two
        client all-reduces a round, of K1's ``[1, N + 1]`` partial and
        the ``[4, 1]`` metric sums.
     q. The tree-state placed round, after phase 3p.  (a) ``tiny`` on
        tree state (float32, FedAWE with K1, m 8, 2 rounds) over phase
        3o's four gloo ranks on card 0, a (4, 1) ('data', 'model') mesh:
        each rank's ``TreePlacement`` holds two client rows, each leaf a
        DTensor on the 'model' sub-mesh; K1's partial form and the
        finalize once per rank a round, the fused K1 never (once a round
        in the unplaced tree round run here beside it); globals and
        client rows within 1e-5 of it, τ, markov, keys, t and counts
        bit-equal, the client leaves on ``client_stack_pspecs``'
        placements; rank 0's collectives counted and printed; the partial
        form at the rank's ``[2, 156 224]`` held against its plain
        version and timed.  On the (2, 2) mesh DTensor's all-gathers over
        'model' of CUDA tensors through gloo segfaulted (torch 2.11), so
        that case runs over four cards under NCCL in
        ``tools/chip_probe_nccl.py --tree``.  (b) gemma2-2b's dry-run tree
        step at published widths, 4 of its 26 layers, as rank 0 of the
        (16, 16) mesh over fake CUDA tensors in a fake group, against the
        same step's CPU record in this run: collective bytes equal, flops
        within 1.0-1.1 of the CPU record's (DTensor's strategy choice
        depends on the mesh's device type), the counted temp peak plus
        the arguments under 80 GB, no card memory allocated.
  4. numbers  — K1-K3: the Triton yardstick's global loads by width in
     its SASS at rows 8 bytes off 16 and at aligned rows; the CUDA kernel
     and the Triton yardstick in turns (K2's yardstick with its own weight
     multiply, as the earlier wrapper launched it), the plain version and
     the two-matvec formulation (K1, K2) at the main-path shape (CUDA
     graphs of calls over rotating operand sets larger than the 50 MB L2),
     K1 and K3 at a 2 GB shape and K1 at the tall shape, each beside the
     HBM bound; K1 at its geometry's slice count and another (what the
     geometry rests on), each wrapper's host-inclusive time a call, and
     two floors at the main path's size (K1 at one row, a PyTorch column
     sum over the same bytes); ms per round of
     the chunked FL path with and without the kernel (CUDA events, in
     turns), the round's pieces timed alone, a profiler breakdown of one
     chunk (every profiled chunk 4 rounds: ``PROFILE_ROUNDS``); ms per
     round and a profiler breakdown of the fault and stale path (with K2
     and with the two matvecs, in turns), one of its chunks
     under ``torch.cuda.set_sync_debug_mode("error")`` (no host read
     inside a round), and the device ms of one ``step_buffer`` over its
     [4, 100, 27 370] ring.  ms per round of each of the ten strategies
     (one chunk at a time, the ten in three turns, each one's median), a
     profiler breakdown of a FedAvg and a FedVARP chunk, and one chunk of
     each strategy, and of MIFA under epoch sampling, under the same
     sync-debug mode.  The 4-seed chunk against the single-seed chunk
     (one setup, one chunk a turn, in turns), seed-rounds per second,
     peak memory and a profiler breakdown of a 4-round 4-seed chunk; the
     batched K1 at [4, 100, 27 370] against four single launches and its
     HBM bound.  K1 and K2 through the tree route against the flat
     wrapper in turns, its plain version and the bound; ms per round of
     the tree and flat rounds with K1 (one chunk a turn, six turns) and a
     profiler breakdown of one tree chunk.  K4 at gemma2-2b's two shapes: kernel, plain
     version, the compiled flex_attention yardstick and SDPA (no soft-cap
     or window) in CUDA events, the bound in tensor-core flops, the
     share of the bound, the kernel's time over the library's and the
     flops its tiles issue (``flash_issued_flops``); prefill ms and
     decode ms per step of the LM path and a profiler breakdown of one
     prefill and one decode step.  K5 at zamba2-7b's and mamba2-130m's
     shapes: the tensor-core kernel and the FP32-pipe kernel in turns,
     the plain version, the bound from ``ssd_chunk_bound`` (tensor cores
     and bytes; the FP32-pipe bound beside it), the share of the bound and
     the flops the tiles issue (``ssd_issued_flops``); no PyTorch call
     computes its function.  K4 at zamba2-7b's attention
     with SDPA (the same function there) as the yardstick; zamba2-7b's
     prefill ms, decode ms per step and a profiler breakdown by part
     (K5, K4, cuBLAS, the inter-chunk loop, the conv).  K4 at
     olmoe-1b-7b's attention (head dim 128), at seamless-m4t-large-v2's
     (head dim 64) and at internvl2-2b's (head dim 128, two query heads
     per kv head) with SDPA (the same function there; ``enable_gqa`` for
     the last) as the yardstick.  K4 at gemma3-27b's two shapes: the
     kernel, the plain version, and the library call computing the same
     function: SDPA (``is_causal``, ``enable_gqa``) at the global shape,
     compiled flex_attention with the sliding-window mask at the windowed
     one.  K1 / K2's partial form at a placed rank's rows ([50, 27 370])
     and at the LM stack's block ([4, 128 983 488]), and the finalize at
     N: kernel and plain version in turns, in CUDA graphs, beside the
     bound.  Each line carries the card's name and power limit.
  5. the ``{"kernels": [...]}`` line (K1 / K2's partial form and the
     finalize with phase 3o's launches, K1's partial form on the tree
     route with phase 3q's; K1 also at the LM training
     stack's [8, N] and the LoRA stack's [4, N], with the full-width
     runs' launches; K4 also at gemma3-27b's windowed and global shapes,
     with the LoRA prefill's launches of each); the last line is
     ``{"ok": true, "device": {...}}``.

No phase catches its own failure: any exception ends the run with a
non-zero exit code and no result line.
"""
import concurrent.futures
import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3's
# rate and the bf16 tensor-core peak are the port's (launch/mesh.py)
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    PEAK_FLOPS_BF16 as BF16_FLOP_PER_S)

FP32_FLOP_PER_S = 67e12
ETA_G = 1.7
MAIN_FLAGS = ["--strategy", "fedawe", "--dynamics", "sine", "--flat-state",
              "--chunk-rounds", "16", "--rounds", "64", "--m", "100",
              "--s", "5", "--batch", "32", "--device", "cuda"]
M_MAIN, N_MAIN = 100, 27370
#: the fault and stale FL path (phase 3e): mid-round dropout with
#: sanitization and geometric delays through a ring of depth 4, discounted
#: by 0.7 at delivery; and every update lost mid-round, synchronously
FAULT_FLAGS = MAIN_FLAGS + ["--midround-drop", "0.3", "--sanitize",
                            "--stale-max", "4", "--stale-kind", "geom",
                            "--stale-p", "0.5", "--stale-gamma", "0.7"]
DROP_ALL_FLAGS = MAIN_FLAGS + ["--midround-drop", "1.0", "--sanitize"]
TAU_MAX, NAN_ROUNDS = 4, 4


def short_name(mangled):
    """`flash_fwd_bf16<256,256,1>` for an instantiation's mangled name
    (int and bool template arguments; the template's name is the one its
    length prefix fits)."""
    m = re.search(r"I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    head = mangled[:m.start()]
    for n in range(len(head) - 1, 0, -1):
        if head.endswith(str(n) + head[-n:]) and head[-n][0].isalpha():
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(1)))
            return f"{head[-n:]}<{args}>"
    return mangled


def ptxas_report(log):
    """ptxas -v's report per kernel instantiation: registers, spills,
    stack, and any remark (C7510-C7515: wgmma serialised, setmaxnreg
    ignored) that names it."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"\(C75\d\d\).*in the function '(\w+)'", line)
        if m:
            out.setdefault(short_name(m.group(1)), {}).setdefault(
                "remarks", []).append(line.split("ptxas info    : ")[-1]
                                      .split(" in the function")[0])
            continue
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = out.setdefault(short_name(m.group(1)), {})
            continue
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("static_smem_bytes", r"(\d+) bytes smem"),
                         ("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                cur[key] = int(m.group(1))
    return out


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(ok, what):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "-i", "0",
                        "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# phase 2: every kernel variant against its plain version
# ---------------------------------------------------------------------------

#: the cohort's shape: a tall stack of m = 16 384 clients at the FL path's
#: N (3.6 GB in float32), the shape the kernel's split over rows is for
TALL_M = 16384
#: the sparse cohort's cap (phase 3h): K1 and K2 see [COHORT_C, N] rows
COHORT_C = 256


def make_inputs(torch, m, n, dtype, seed, mask_p=0.7, upload=False,
                offset=False):
    """x, y [m, n] in ``dtype``, g [n], mask, echo, upload [m] on the card.
    ``offset``: x and y are rows 1.. of [m + 1, n] stacks, so that with n
    odd they start off a 16-byte boundary."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    lead = 1 if offset else 0
    x = rand(m + lead, n).to(dtype)[lead:]
    y = rand(m + lead, n).to(dtype)[lead:]
    g = rand(n)
    mask = (torch.rand(m, generator=gen, device="cuda") < mask_p).float()
    echo = torch.randint(1, 12, (m,), generator=gen, device="cuda").float()
    up = None
    if upload:
        up = 0.8 ** torch.randint(0, 4, (m,), generator=gen,
                                  device="cuda").float()
    return dict(x=x, y=y, g=g, mask=mask, echo=echo, upload=up)


def call_kernel(ops, variant, a):
    if variant == "K3":
        return ops.echo_aggregate(a["x"], a["y"], a["mask"], a["echo"],
                                  ETA_G)
    return ops.echo_aggregate_flat(a["x"], a["y"], a["g"], a["mask"],
                                   a["echo"], ETA_G, upload=a["upload"])


def call_forced(ops, variant, a, slices):
    """The CUDA kernel at ``slices`` row slices (no launch counted)."""
    return ops._echo_aggregate_cuda(
        a["x"], a["y"], None if variant == "K3" else a["g"], a["mask"],
        a["echo"], ETA_G, upload=a["upload"], slices=slices)


def call_triton(ops, variant, a):
    """The earlier Triton kernel as the earlier wrapper launched it (for
    K2 after its own multiply of the weights)."""
    return ops._echo_aggregate_triton(
        a["x"], a["y"], None if variant == "K3" else a["g"], a["mask"],
        a["echo"], ETA_G, upload=a["upload"])


def call_plain(ref, variant, a):
    if variant == "K3":
        return ref.echo_aggregate_ref(a["x"], a["y"], a["mask"], a["echo"],
                                      ETA_G)
    return ref.echo_aggregate_fused_ref(a["x"], a["y"], a["g"], a["mask"],
                                        a["echo"], ETA_G, upload=a["upload"])


def call_split(ref, variant, a, slices):
    return ref.echo_aggregate_split_ref(
        a["x"], a["y"], None if variant == "K3" else a["g"], a["mask"],
        a["echo"], ETA_G, slices=slices, upload=a["upload"])


def launch_count(ops, variant):
    return {"K1": ops.echo_aggregate_flat.launches,
            "K2": ops.echo_aggregate_flat.upload_launches,
            "K3": ops.echo_aggregate.launches}[variant]


def n_sm(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


#: K1-K3 cases, (variant, m, n, dtype name, extra): the main path's shape;
#: N = 1; 3 column tiles + 5; bfloat16; empty rounds; the 2 GB shape; N odd
#: (rows 4-byte aligned in float32, 2-byte in bfloat16), also with the
#: stacks starting off a 16-byte boundary (``offset``); m = 1; m = 7 at 8
#: forced slices (fewer rows than slices); the main-path shape at 3 forced
#: slices (timed beside its own geometry's 1); the tall shape (3 slices);
#: the cohort's working set, [256, N] (phase 3h)
ECHO_CASES = [
    ("K1", M_MAIN, N_MAIN, "float32", {}),
    ("K2", M_MAIN, N_MAIN, "float32", dict(upload=True)),
    ("K3", M_MAIN, N_MAIN, "float32", {}),
    ("K1", 8, 1, "float32", {}),
    ("K1", 37, 3 * 256 + 5, "float32", {}),
    ("K3", 37, 3 * 256 + 5, "float32", {}),
    ("K1", M_MAIN, N_MAIN, "bfloat16", {}),
    ("K2", M_MAIN, N_MAIN, "bfloat16", dict(upload=True)),
    ("K1", 16, 1000, "float32", dict(mask_p=0.0)),
    ("K2", 16, 1000, "float32", dict(mask_p=0.0, upload=True)),
    ("K1", 1024, 262144, "float32", {}),
    ("K3", 1024, 262144, "float32", {}),
    ("K1", 64, 4099, "float32", {}),
    ("K2", 64, 4099, "bfloat16", dict(upload=True)),
    ("K2", 37, 4099, "float32", dict(upload=True, offset=True)),
    ("K3", 37, 4099, "bfloat16", dict(offset=True)),
    ("K1", 1, N_MAIN, "float32", {}),
    ("K2", 1, N_MAIN, "bfloat16", dict(upload=True)),
    ("K1", 7, N_MAIN, "float32", dict(slices=8)),
    ("K2", 7, 4099, "bfloat16", dict(upload=True, slices=8)),
    ("K3", 7, 4099, "float32", dict(slices=8, offset=True)),
    ("K2", M_MAIN, N_MAIN, "float32", dict(upload=True, slices=3)),
    ("K1", TALL_M, N_MAIN, "float32", {}),
    ("K1", COHORT_C, N_MAIN, "float32", {}),
    ("K2", COHORT_C, N_MAIN, "float32", dict(upload=True)),
]
#: cases up to this many rows are also held against the kernel's own
#: arithmetic, ``echo_aggregate_split_ref`` (a Python loop over rows)
SPLIT_REF_MAX_M = 128


def check_kernels(torch, ops, ref):
    """Each case: two calls on the same inputs, which must give equal bits
    (through the checked wrapper, which must count exactly one launch
    each, or at forced slices through ``ops._echo_aggregate_cuda``); the
    plain version within the stated tolerance; up to ``SPLIT_REF_MAX_M``
    rows, the split oracle at the launch's slices, which repeats the
    kernel's roundings, to the bit; an empty round returns g exactly.
    Returns the max abs error per variant at the main-path shape in
    float32, at the launch's own slices."""
    errs = {}
    for i, (variant, m, n, dname, extra) in enumerate(ECHO_CASES):
        dtype = getattr(torch, dname)
        extra = dict(extra)
        forced = extra.pop("slices", None)
        a = make_inputs(torch, m, n, dtype, seed=100 + i, **extra)
        block_cols, slices = ops.launch_geometry(m, n, a["x"].element_size(),
                                                 n_sm(torch))
        before = launch_count(ops, variant)
        if forced is None:
            outs = [call_kernel(ops, variant, a) for _ in range(2)]
        else:
            slices = forced
            outs = [call_forced(ops, variant, a, slices) for _ in range(2)]
        torch.cuda.synchronize()
        launched = launch_count(ops, variant) - before
        out = outs[0]
        same_bits = torch.equal(outs[0], outs[1])
        plain = call_plain(ref, variant, a)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 5e-2
        err = (out - plain).abs().max().item()
        split_err = split_equal = None
        if m <= SPLIT_REF_MAX_M:
            split = call_split(ref, variant, a, slices)
            split_err = (out - split).abs().max().item()
            split_equal = torch.equal(out, split)
        empty = extra.get("mask_p") == 0.0
        ok = (launched == (2 if forced is None else 0) and same_bits
              and out.shape == (n,) and out.dtype == torch.float32
              and bool(torch.isfinite(out).all())
              and torch.allclose(out, plain, rtol=tol, atol=tol)
              and split_equal is not False
              and (not empty or torch.equal(out, a["g"])))
        emit(dict(phase="kernel_check", kernel=variant, m=m, n=n,
                  dtype=dname, block_cols=block_cols, slices=slices,
                  forced_slices=forced is not None,
                  offset=bool(extra.get("offset")), empty_mask=empty,
                  launches=launched, two_launches_bit_equal=same_bits,
                  max_abs_err=err, split_ref_err=split_err,
                  split_ref_bit_equal=split_equal, tol=tol, ok=ok))
        if not ok:
            raise AssertionError(f"kernel {variant} at ({m}, {n}, {dname}) "
                                 "disagrees with its plain version")
        if (m, n, dtype) == (M_MAIN, N_MAIN, torch.float32) \
                and forced is None:
            errs[variant] = err
        del a, outs, out, plain
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def graph_ms(torch, fn, n_calls, reps=5):
    """Device time per call: ``n_calls`` calls captured in one CUDA graph
    (no host launch overhead between them), replayed ``reps`` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * n_calls)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(m, n, esize, with_g, with_upload=False, seeds=1):
    """Least time in ms: each operand read once and the output written
    once (x, y at ``esize`` bytes; g, out and the [m] vectors mask, echo
    and, for K2, upload in float32), against about 5 float32 operations
    per (client, column) element; ``seeds`` times that for a launch over
    a seed axis."""
    nbytes = seeds * (2 * m * n * esize + 4 * n * (2 if with_g else 1)
                      + 4 * m * (3 if with_upload else 2))
    flops = 5 * seeds * m * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def in_turns(torch, fn_new, fn_old, n_calls):
    """``graph_ms`` of the CUDA kernel and of the Triton yardstick in
    turns: new, old, old, new."""
    t = [graph_ms(torch, f, n_calls)
         for f in (fn_new, fn_old, fn_old, fn_new)]
    return dict(ms=(t[0] + t[3]) / 2, turns_ms=[t[0], t[3]],
                triton_ms=(t[1] + t[2]) / 2, triton_turns_ms=[t[1], t[2]])


def time_kernels(torch, ops, ref, strategies, smi):
    """The CUDA kernel and the Triton yardstick in turns, and the plain
    version, per variant at the main-path shape over 8 rotating operand
    sets (8 x 21.9 MB, so no set is still in the 50 MB L2 when it comes
    round again); K2's Triton time includes its weight multiply, as the
    earlier wrapper launched it; the two-matvec formulation of K1 and K2;
    then K1 and K3 at the 2 GB shape and K1 at the tall shape."""
    out = {}
    sets = [make_inputs(torch, M_MAIN, N_MAIN, torch.float32, seed=500 + i,
                        upload=True) for i in range(8)]
    noup = [dict(a, upload=None) for a in sets]
    # the reference's use_kernel=False formulation: G = x - y is an input
    # there (the round computes it anyway), and under faults the weights
    # mask * upload come in ready-made (``mask_upload``)
    Gs = [a["x"] - a["y"] for a in sets]
    mus = {"K1": [a["mask"] for a in sets],
           "K2": [a["mask"] * a["upload"] for a in sets]}

    def two_matvec(variant):
        def fn(i):
            a, G, mu = sets[i % 8], Gs[i % 8], mus[variant][i % 8]
            denom = torch.clamp(torch.sum(mu), min=1.0)
            acc = (strategies.flat_weighted_sum(mu, a["x"]) - ETA_G
                   * strategies.flat_weighted_sum(mu * a["echo"], G)) / denom
            return torch.where(torch.sum(mu) > 0, acc, a["g"])
        return fn

    for variant, src in (("K1", noup), ("K2", sets), ("K3", noup)):
        rec = in_turns(
            torch, lambda i: call_kernel(ops, variant, src[i % 8]),
            lambda i: call_triton(ops, variant, src[i % 8]), 64)
        rec["plain_ms"] = graph_ms(
            torch, lambda i: call_plain(ref, variant, src[i % 8]), 64)
        b_ms, b_by, nbytes = bound(M_MAIN, N_MAIN, 4, variant != "K3",
                                   variant == "K2")
        rec.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                   share=b_ms / rec["ms"], triton_share=b_ms / rec["triton_ms"],
                   two_matvec_ms=(graph_ms(torch, two_matvec(variant), 64)
                                  if variant in mus else None))
        out[variant] = rec
    del sets, noup, Gs, mus
    torch.cuda.empty_cache()
    for key, m, n, variants in (("large", 1024, 262144, ("K1", "K3")),
                                ("tall", TALL_M, N_MAIN, ("K1",))):
        big = make_inputs(torch, m, n, torch.float32, seed=900)
        for variant in variants:
            rec = in_turns(torch, lambda i: call_kernel(ops, variant, big),
                           lambda i: call_triton(ops, variant, big), 10)
            b_ms, b_by, nbytes = bound(m, n, 4, variant != "K3")
            out[variant][key] = dict(
                m=m, n=n, **rec, bound_ms=b_ms, bound_by=b_by,
                share=b_ms / rec["ms"], triton_share=b_ms / rec["triton_ms"],
                achieved_gb_per_s=nbytes / rec["ms"] / 1e6)
        del big
        torch.cuda.empty_cache()
    out["K1"]["slices_ms"] = slice_times(torch, ops)
    out["K1"]["host_us"] = host_times(torch, ops)
    out["K1"]["floors_ms"] = floor_times(torch, ops)
    for variant, rec in out.items():
        emit(dict(phase="kernel_time", card=smi, kernel=variant, m=M_MAIN,
                  n=N_MAIN, **rec))
    return out


def slice_times(torch, ops):
    """K1 at the geometry's slice count and at another, in turns: the
    main-path shape at 1 (its own) and 3, the tall shape at 3 (its own)
    and 1: what ``ops.launch_geometry``'s rule rests on."""
    out = {}
    for key, m, n, other, sets in (("main", M_MAIN, N_MAIN, 3, 8),
                                   ("tall", TALL_M, N_MAIN, 1, 1)):
        src = [make_inputs(torch, m, n, torch.float32, seed=700 + i)
               for i in range(sets)]
        own = ops.launch_geometry(m, n, 4, n_sm(torch))[1]
        t = {own: [], other: []}
        for s in (own, other, other, own):
            t[s].append(graph_ms(torch, lambda i: call_forced(
                ops, "K1", src[i % sets], s), 64 if sets > 1 else 10))
        out[key] = {f"S{s}": v for s, v in t.items()}
        del src
        torch.cuda.empty_cache()
    return out


def floor_times(torch, ops):
    """What a pass over the main path's stacks costs beyond its bytes: K1
    at one client row (N = 27 370: launch, one row's latency, the store),
    and a PyTorch column sum over the same 22 MB ([200, 27 370] float32),
    each over 8 rotating operand sets in a CUDA graph."""
    sets = [make_inputs(torch, 1, N_MAIN, torch.float32, seed=800 + i)
            for i in range(8)]
    stacks = [torch.randn(2 * M_MAIN, N_MAIN, device="cuda")
              for _ in range(8)]
    out = dict(k1_one_row=graph_ms(torch, lambda i: call_kernel(
        ops, "K1", sets[i % 8]), 64),
               torch_sum_22mb=graph_ms(
                   torch, lambda i: stacks[i % 8].sum(0), 64))
    del sets, stacks
    torch.cuda.empty_cache()
    return out


def host_times(torch, ops):
    """Microseconds a call of the wrapper takes between CUDA events, one
    call after another with no graph (the host's launch work included, as
    a round sees it): K1 and K2 through the CUDA kernel and through the
    Triton yardstick, at the main-path shape."""
    a = make_inputs(torch, M_MAIN, N_MAIN, torch.float32, seed=11,
                    upload=True)
    b = dict(a, upload=None)
    out = {}
    for name, fn in (("K1", lambda: call_kernel(ops, "K1", b)),
                     ("K1 triton", lambda: call_triton(ops, "K1", b)),
                     ("K2", lambda: call_kernel(ops, "K2", a)),
                     ("K2 triton", lambda: call_triton(ops, "K2", a))):
        out[name] = 1e3 * events_ms(torch, fn, 500)
    return out


def load_widths(path):
    """Global loads in the SASS of a cubin or shared library, by opcode
    (``LDG.E`` 4 bytes, ``LDG.E.64`` 8, ``LDG.E.128`` 16; ``LDGSTS``,
    cp.async, likewise; ``UBLKCP``, a bulk copy), per function, from
    ``cuobjdump -sass``."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        import triton
        tool = os.path.join(os.path.dirname(triton.__file__), "backends",
                            "nvidia", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = short_name(fn.split("\n", 1)[0].strip())
        ops = {}
        for op in re.findall(
                r"\b((?:LDG(?:STS)?|UBLKCP)(?:\.[A-Z0-9_]+)*)(?!\w)", fn):
            ops[op] = ops.get(op, 0) + 1
        out[name] = ops
    return out


def triton_load_widths(torch, ops, smi):
    """The Triton yardstick's global loads at the main path's N (rows 8
    bytes off 16 in float32) and at N = 262 144 (16-byte aligned rows):
    each shape compiled alone into the cache, its new cubins read."""
    def cubins():
        # the cache directory is set at the yardstick's first compile
        found = set()
        for root, _, names in os.walk(os.environ.get("TRITON_CACHE_DIR",
                                                     os.devnull)):
            found.update(os.path.join(root, f) for f in names
                         if f.endswith(".cubin"))
        return found

    # (100, 27 376): the main path's m with 16-byte aligned rows
    for m, n in ((M_MAIN, N_MAIN), (1024, 262144), (M_MAIN, N_MAIN + 6)):
        seen = cubins()
        a = make_inputs(torch, m, n, torch.float32, seed=7)
        call_triton(ops, "K1", a)
        torch.cuda.synchronize()
        for path in sorted(cubins() - seen):
            emit(dict(phase="sass_loads", card=smi, kernel="triton K1",
                      m=m, n=n, row_bytes_mod_16=4 * n % 16,
                      cubin=os.path.relpath(path, REPO),
                      loads=load_widths(path)))
        del a


def chunk_setup(torch, train, engine, federated, flags):
    """The chunked path of ``flags`` built as the launcher builds it (its
    sampler mode included), after one warm chunk: a dict with the
    ``state``, the sampler carry ``ss``, the ``chunk`` executor and what
    it is called with."""
    args = train.build_parser().parse_args(flags)
    dev = torch.device("cuda")
    parts = train.setup(args, dev)
    store = parts["ds"].device_store(dev)
    init, sample = federated.make_device_sampler(
        args.m, args.s, args.batch, mode=args.sampling,
        min_count=min(len(ix) for ix in parts["ds"].client_indices))
    key = parts["data_key"]
    chunk = engine.make_chunk_fn(None, parts["round_fn"], sample,
                                 args.chunk_rounds)
    state, ss = parts["state"], init(store, key)
    state, ss, _ = chunk(state, ss, store, key)
    torch.cuda.synchronize()
    return dict(state=state, ss=ss, chunk=chunk, store=store, key=key,
                sample=sample, args=args, round_fn=parts["round_fn"])


def chunks_ms(torch, r, n_chunks):
    """ms per round of ``n_chunks`` more chunks of ``chunk_setup``'s run
    ``r`` between CUDA events; ``r`` carries the state on."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_chunks):
        r["state"], r["ss"], _ = r["chunk"](r["state"], r["ss"], r["store"],
                                            r["key"])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n_chunks * r["args"].chunk_rounds)


def time_rounds(torch, train, engine, federated, prng, use_kernel,
                n_chunks=2, flags=MAIN_FLAGS):
    """ms per round of the chunked path of ``flags`` between CUDA events
    over ``n_chunks`` chunks, after one warm chunk."""
    flags = flags + (["--use-kernel"] if use_kernel else [])
    r = chunk_setup(torch, train, engine, federated, flags)
    round_ms = chunks_ms(torch, r, n_chunks)
    return dict(r, round_ms=round_ms, rounds_per_s=1e3 / round_ms)


def events_ms(torch, fn, reps):
    """Mean ms per call of ``fn`` between CUDA events (after one warm
    call): host launch overhead included, as a round sees it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def round_parts_ms(torch, prng, engine, strategies, cnn, timing, reps=16):
    """Pieces of one main-path round, each run alone on the round's own
    shapes: every PRNG call of a round together (split(rng, 3), the
    mask's uniform, split(k_loc, m), the s per-step splits of the [m, 2]
    keys, the sampler's fold_in + randint), the sampler (fold_in +
    randint + gather), local SGD (s steps, m clients, its key splits
    included) and the FedAWE server update with the kernel.  The PRNG
    piece overlaps the sampler and local SGD, so the pieces do not sum
    to the round."""
    args, state, store = timing["args"], timing["state"], timing["store"]
    rng = prng.PRNGKey(0, "cuda")
    t = state.t
    counts = store["counts"][:, None]

    def draws():
        keys = prng.split(rng, 3)
        prng.uniform(keys[1], (args.m,))
        loc = prng.split(keys[2], args.m)
        for _ in range(args.s):
            loc = prng.split(loc)[:, 0]
        prng.randint(prng.fold_in(timing["key"], t),
                     (args.m, args.s * args.batch), 0, counts)

    def sampler():
        return timing["sample"](store, {}, prng.fold_in(timing["key"], t))

    batches, _ = sampler()
    spec = state.spec
    start = spec.unflatten_stacked(state.clients_tr)
    loc_keys = prng.split(rng, args.m)
    loss_fn = cnn.make_image_loss_fn(cnn.cnn_apply)

    def local():
        return engine.local_sgd(start, {}, batches, loc_keys, s=args.s,
                                eta_l=args.eta_l, loss_fn=loss_fn,
                                grad_clip=0.5)

    x_end = spec.flatten_stacked(local()[0])
    mask = (torch.arange(args.m, device="cuda") % 3 == 0).float()

    def aggregate():
        return strategies.get_strategy("fedawe").aggregate_flat(
            global_flat=state.global_tr, clients_flat=state.clients_tr,
            x_end=x_end, G=state.clients_tr - x_end, mask=mask, t=t,
            tau=state.tau, probs=None, extra=(), eta_g=args.eta_g,
            use_kernel=True)

    return dict(prng_ms=events_ms(torch, draws, reps),
                sampler_ms=events_ms(torch, sampler, reps),
                local_sgd_ms=events_ms(torch, local, reps),
                aggregate_ms=events_ms(torch, aggregate, reps))


#: rounds of a profiled chunk of a ``chunk_setup`` path: the profiler's
#: event list grows with the launches (profiling whole 16-round chunks
#: took about 200 s of a 992 s run, and a run on a slower host 1 168 s of
#: the 1 200 allowed)
PROFILE_ROUNDS = 4


def profile_chunk(torch, timing, round_ms):
    """One chunk under torch.profiler: summed device time of all kernels
    per round, its share of the unprofiled ``round_ms`` (the device busy
    share; the profiler slows the host, so its own wall time is reported
    apart), launches per round and the top kernels by device time and by
    launches.  A ``chunk_setup`` path's chunk is cut to PROFILE_ROUNDS.
    Device fields are None when the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine

    state, ss = timing["state"], timing["ss"]
    chunk, rounds = timing["chunk"], timing["args"].chunk_rounds
    if "round_fn" in timing and rounds > PROFILE_ROUNDS:
        rounds = PROFILE_ROUNDS
        chunk = engine.make_chunk_fn(None, timing["round_fn"],
                                     timing["sample"], rounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, ss, _ = chunk(state, ss, timing["store"], timing["key"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(us for _, us in kernels)
    by_name = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    n_by_name = {}
    for name, _ in kernels:
        n_by_name[name] = n_by_name.get(name, 0) + 1
    most = sorted(n_by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(profiled_wall_ms_per_round=wall_ms / rounds,
                device_ms_per_round=(dev_us / 1e3 / rounds
                                     if kernels else None),
                device_busy_share=(dev_us / 1e3 / rounds / round_ms
                                   if kernels else None),
                kernel_launches_per_round=(len(kernels) / rounds
                                           if kernels else None),
                top_kernels_ms_per_round=[
                    [name[:80], us / 1e3 / rounds] for name, us in top],
                top_kernels_launches_per_round=[
                    [name[:80], n / rounds] for name, n in most])


# ---------------------------------------------------------------------------
# K4: flash attention against its plain version, and its numbers
# ---------------------------------------------------------------------------

#: tests/test_kernels.py:84-91 (six cases) and the window's lower edge,
#: (B, H, K, L, S, D, window, softcap, causal)
FLASH_CASES = [
    (2, 4, 4, 64, 64, 32, None, 0.0, True),
    (1, 4, 2, 32, 64, 16, None, 0.0, True),
    (2, 2, 2, 64, 64, 32, 24, 0.0, True),
    (1, 2, 1, 64, 64, 64, None, 20.0, True),
    (1, 2, 2, 64, 64, 32, None, 0.0, False),
    (1, 8, 4, 128, 128, 64, 48, 30.0, True),
    (1, 4, 2, 64, 64, 32, 5, 0.0, True),
    (1, 4, 2, 64, 64, 32, None, 0.0, True),        # the dtype case :108
]
#: head dim 256 (the main path's build of the kernel) at short lengths,
#: where the outputs are O(1): window 17 and soft-cap 50, global, a suffix
HEAD256_CASES = [(1, 8, 4, 96, 96, 256, 17, 50.0, True),
                 (1, 8, 4, 256, 256, 256, 17, 50.0, True),
                 (1, 8, 4, 256, 256, 256, None, 50.0, True),
                 (1, 8, 4, 64, 256, 256, 17, 50.0, True)]
#: gemma2-2b's attention at the main path's prefill (B 2, L = S = 8192):
#: windowed (local layers) and global, then a suffix with S > L
GEMMA_ATTN = [(2, 8, 4, 8192, 8192, 256, 4096, 50.0, True),
              (2, 8, 4, 8192, 8192, 256, None, 50.0, True),
              (2, 8, 4, 1024, 8192, 256, 4096, 50.0, True)]
#: ragged shapes for the bf16 kernel's TMA out-of-bounds fill and edge
#: tiles: L and S not multiples of its 128-query or 64-key tiles, head dim
#: 112 (zamba2-7b's, products over 112 of the 128 padded dims) with GQA
#: and a window, suffixes with L < S, head dim 16 (padded to 64), head dim
#: 128 with GQA, a window and a soft-cap
FLASH_RAGGED_CASES = [(1, 4, 2, 100, 100, 64, None, 0.0, True),
                      (2, 8, 4, 200, 333, 256, 77, 50.0, True),
                      (1, 8, 2, 130, 130, 112, 40, 0.0, True),
                      (1, 4, 4, 70, 300, 112, None, 0.0, False),
                      (1, 2, 1, 129, 257, 16, 3, 20.0, True),
                      (2, 4, 2, 200, 333, 128, 77, 30.0, True)]
FLASH_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # tests/test_kernels.py
#: every output row (one query, one head) against its own scale: max over
#: the head dim of |kernel - plain| over max over the head dim of |plain|.
#: A row that averages thousands of keys has a largest output near 0.08
#: (the median row at the gemma2-2b shapes), where the absolute bound
#: above would pass almost anything; in bfloat16 2e-2 is
#: 2.5 ulps of the row's largest element, while a key tile missed or
#: added in such a row moves it by several per cent
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LM_B, LM_L, LM_NEW, LM_LAYERS = 2, 8192, 16, 26
#: flash vs xla prefill at full width: float32 end to end, 26 layers of
#: reordered sums (the reference's own test allows 2e-4 at 4 layers);
#: bfloat16 layer by layer on the same layer inputs (one attention call's
#: rounding: bf16 ulps of outputs up to 4-8), and end to end as distance
#: from the float32 prefill on the same (bf16-valued) weights: the
#: kernel's path no farther than LM_TRUTH_RATIO times the xla path's
LM_TOL_F32 = 1e-3
LM_TOL_BF16_LAYER = 5e-2
LM_TRUTH_RATIO = 1.5
#: the drift witness: reduced gemma2-2b at head dim 256 (the main path's
#: build of the kernel) in bfloat16, B 2 prompts of 256 tokens, weights
#: and tokens drawn with numpy from WITNESS_SEED (``witness_arrays``) so
#: that the JAX package builds the same ones
WITNESS_B, WITNESS_L, WITNESS_SEED = 2, 256, 11
#: the reference's own bfloat16 flash-vs-xla drift at the witness (the JAX
#: package on the CPU, its Pallas kernel in interpret mode; recomputed by
#: tests/test_torch_bf16_drift.py): per layer, max |attention sub-block
#: output, flash - xla| on the xla run's own layer input; end to end,
#: max |logits| and max |cache k, v| differences of the prefill.  The
#: port's kernel must stay within WITNESS_RATIO times each: the
#: differences are whole bf16 ulps, and one ulp flipped one binade higher
#: doubles a maximum, while a wrong key tile moves outputs by tenths
REF_DRIFT = dict(layers=[0.015625, 0.015625, 0.015625, 0.015625],
                 logits=0.015624642372131348, cache=0.0625)
WITNESS_RATIO = 4.0


def flash_inputs(torch, case, dtype, seed):
    """Model-layout q [B, L, H, D], k and v [B, S, K, D] on the card."""
    B, H, K, L, S, D = case[:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return rand(B, L, H, D), rand(B, S, K, D), rand(B, S, K, D)


def flash_kw(case):
    return dict(window=case[6], softcap=case[7], causal=case[8])


def row_rel_err(out, plain):
    """The largest, over output rows, of max |out - plain| / max |plain|
    along the head dim."""
    err = (out.float() - plain.float()).abs().amax(-1)
    scale = plain.float().abs().amax(-1).clamp_min(1e-30)
    return (err / scale).max().item()


#: the tiled plain version loops over tiles in Python; past this many
#: queries (the full-length gemma2-2b and zamba2-7b cases) it is not run
TILED_MAX_L = 1024
#: past this many bytes of float32 scores the plain version runs one batch
#: row at a time (gemma3-27b's 32 heads at B 2, L = S = 8192: 17.2 GB)
PLAIN_SCORE_BYTES = 2 ** 33


def plain_flash(fref, q, k, v, case):
    """The plain version at ``case``: whole, or one batch row at a time
    (concatenated) where its scores would pass PLAIN_SCORE_BYTES."""
    B, H, _, L, S = case[:5]
    if 4 * B * H * L * S <= PLAIN_SCORE_BYTES:
        return fref.flash_mha_ref(q, k, v, **flash_kw(case))
    import torch

    return torch.cat([fref.flash_mha_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                         **flash_kw(case))
                      for b in range(B)])


def check_flash(torch, fops, fref):
    """Every case, float32 and bfloat16: one wrapper call (exactly one
    launch), the plain version on the same tensors, the absolute bound of
    tests/test_kernels.py and the row-scaled one; in bfloat16 up to
    TILED_MAX_L queries also the same bounds against
    ``flash_mha_tiled_ref``, the kernel's own algorithm in plain torch.
    Returns the largest error of each main path's cases in bfloat16: at
    the gemma2-2b shapes (head dim 256, key "gemma"), at olmoe-1b-7b's
    (head dim 128, "olmoe"), at seamless-m4t-large-v2's (head dim 64,
    "seamless"), at internvl2-2b's (head dim 128 with G = 2, "internvl")
    and at gemma3-27b's windowed and global ones (head dim 128 with G = 2,
    "gemma3_windowed", "gemma3_global")."""
    worst = dict(gemma=0.0, olmoe=0.0, seamless=0.0, internvl=0.0,
                 gemma3_windowed=0.0, gemma3_global=0.0)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for i, case in enumerate(FLASH_CASES + HEAD256_CASES + GEMMA_ATTN
                                 + ZAMBA_ATTN_CHECK + FLASH_RAGGED_CASES
                                 + MOE_ATTN_CHECK + ENCDEC_ATTN_CHECK
                                 + GEMMA3_ATTN):
            q, k, v = flash_inputs(torch, case, dtype, seed=300 + i)
            before = fops.flash_mha.launches
            out = fops.flash_mha(q, k, v, **flash_kw(case))
            torch.cuda.synchronize()
            launched = fops.flash_mha.launches - before
            plain = plain_flash(fref, q, k, v, case)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            row_err = row_rel_err(out, plain)
            tol = FLASH_TOL[name]
            ok = (launched == 1 and out.shape == q.shape
                  and out.dtype == dtype
                  and bool(torch.isfinite(out).all())
                  and torch.allclose(out.float(), plain.float(), rtol=tol,
                                     atol=tol)
                  and row_err <= FLASH_ROW_TOL[name])
            tiled = {}
            if dtype == torch.bfloat16 and case[3] <= TILED_MAX_L:
                ref_t = fref.flash_mha_tiled_ref(q, k, v, **flash_kw(case))
                tiled = dict(
                    tiled_max_abs_err=(out.float() - ref_t.float()).abs()
                    .max().item(),
                    tiled_row_rel_err=row_rel_err(out, ref_t))
                ok = ok and torch.allclose(out.float(), ref_t.float(),
                                           rtol=tol, atol=tol) \
                    and tiled["tiled_row_rel_err"] <= FLASH_ROW_TOL[name]
                del ref_t
            emit(dict(phase="kernel_check", kernel="K4", shape=case[:6],
                      window=case[6], softcap=case[7], causal=case[8],
                      dtype=name, launches=launched, max_abs_err=err,
                      tol=tol, plain_absmax=plain.float().abs().max().item(),
                      plain_row_absmax_median=plain.float().abs().amax(-1)
                      .median().item(),
                      row_rel_err=row_err, row_tol=FLASH_ROW_TOL[name],
                      **tiled, ok=ok))
            if not ok:
                raise AssertionError(f"flash attention at {case} {name} "
                                     "disagrees with its plain version")
            if dtype == torch.bfloat16 and case in GEMMA_ATTN[:2]:
                worst["gemma"] = max(worst["gemma"], err)
            for key, main in (("olmoe", OLMOE_ATTN),
                              ("seamless", SEAMLESS_ATTN),
                              ("internvl", INTERNVL_ATTN),
                              ("gemma3_windowed", GEMMA3_ATTN[0]),
                              ("gemma3_global", GEMMA3_ATTN[1])):
                if dtype == torch.bfloat16 and case == main:
                    worst[key] = err
            del q, k, v, out, plain
    torch.cuda.empty_cache()
    return worst


def live_pairs(L, S, causal, window):
    """(query, key) pairs the masks leave, for end-aligned queries."""
    n = 0
    for i in range(L):
        p = i + S - L
        hi = min(p, S - 1) if causal else S - 1
        lo = max(0, p - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def flash_bound(case, esize, flop_per_s):
    """Least time in ms: q, k, v read once and the output written once
    over the HBM rate, against 4 * D flops per live (query, key) pair per
    head over the peak rate of the kernel's arithmetic."""
    B, H, K, L, S, D, window, _, causal = case
    nbytes = esize * (2 * B * H * L * D + 2 * B * K * S * D)
    flops = 4 * D * B * H * live_pairs(L, S, causal, window)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", flops)


#: the bf16 kernel's tiles (kernels/flash_attention/csrc: kBM, kBN)
FLASH_BM, FLASH_BN = 128, 64


def flash_product_dims(D):
    """Head dims the bf16 kernel's products run over: 112 at head dim 112,
    else D padded to 64, 128 or 256."""
    return 112 if D == 112 else 64 if D <= 64 else 128 if D <= 128 else 256


def flash_issued_flops(case, BM, BN, DP):
    """Tensor-core flops the bf16 kernel issues for ``case``: every query
    tile of BM rows loads the key tiles of BN keys from its first row's
    oldest live key to its last real row's newest one, and each of its
    BM / 64 warpgroups runs q.k^T and p.v over DP head dims on every such
    tile (diagonal, window-edge and ragged tiles, and warpgroups past L,
    whole)."""
    B, H, K, L, S, D, window, _, causal = case
    off, tiles = S - L, 0
    for r0 in range(0, L, BM):
        kb, ke = 0, S
        if causal:
            ke = min(ke, min(r0 + BM, L) + off)
        if window:
            kb = max(kb, r0 + off - window + 1)
        if ke > kb:
            tiles += (ke + BN - 1) // BN - kb // BN
    return B * H * tiles * (BM // 64) * 2 * (2 * 64 * BN * DP)


def flex_call(torch, q, k, v, window, softcap):
    """The yardstick: one compiled torch flex_attention call computing the
    same function (a soft-cap score_mod where ``softcap`` is set, causal
    + window block mask, GQA)
    on the [B, H, L, D] layout.  Timed here only; the port never calls
    it.  Compiled anew for each window (the compile cache would otherwise
    keep the first mask function)."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    torch.compiler.reset()

    def capped(score, b, h, qi, ki):
        return torch.tanh(score / softcap) * softcap

    def mask_mod(b, h, qi, ki):
        ok = qi >= ki
        if window is not None:
            ok = ok & (qi - ki < window)
        return ok

    L = q.shape[2]
    mask = create_block_mask(mask_mod, None, None, L, L, device="cuda")
    fn = torch.compile(flex_attention)
    score_mod = capped if softcap else None
    return lambda: fn(q, k, v, score_mod=score_mod, block_mask=mask,
                      enable_gqa=True)


def time_flash(torch, fops, fref, smi):
    """K4 at the main path's two shapes (bf16, windowed and global): the
    kernel over 20 calls, the plain version over 2, the flex_attention
    yardstick over 20 (and its error against the plain version), SDPA
    without soft-cap or window (not the same function) for scale, the
    float32 kernel over 2; CUDA events after a warm call."""
    out = {}
    for case in GEMMA_ATTN[:2]:
        tag = "windowed" if case[6] else "global"
        q, k, v = flash_inputs(torch, case, torch.bfloat16, seed=700)
        kw = flash_kw(case)
        k_ms = events_ms(torch, lambda: fops.flash_mha(q, k, v, **kw), 20)
        plain = fref.flash_mha_ref(q, k, v, **kw)
        p_ms = events_ms(torch, lambda: fref.flash_mha_ref(q, k, v, **kw), 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t0 = time.perf_counter()
        flex = flex_call(torch, qt, kt, vt, case[6], case[7])
        flex_err = (flex().transpose(1, 2).float()
                    - plain.float()).abs().max().item()
        flex_compile_s = time.perf_counter() - t0
        f_ms = events_ms(torch, flex, 20)
        sdpa_ms = events_ms(torch, lambda: torch.nn.functional
                            .scaled_dot_product_attention(
                                qt, kt, vt, is_causal=True, enable_gqa=True),
                            5)
        del plain, flex
        b_ms, b_by, flops = flash_bound(case, 2, BF16_FLOP_PER_S)
        q32, k32, v32 = (x.float() for x in (q, k, v))
        f32_ms = events_ms(torch, lambda: fops.flash_mha(q32, k32, v32,
                                                         **kw), 2)
        f32_bound, f32_by, _ = flash_bound(case, 4, FP32_FLOP_PER_S)
        issued = flash_issued_flops(case, FLASH_BM, FLASH_BN,
                                    flash_product_dims(case[5]))
        out[tag] = dict(ms=k_ms, plain_ms=p_ms, library_ms=f_ms,
                        library="torch flex_attention (compiled)",
                        library_max_abs_err=flex_err,
                        library_compile_s=flex_compile_s,
                        sdpa_no_softcap_no_window_ms=sdpa_ms,
                        bound_ms=b_ms, bound_by=b_by, flops=flops,
                        tflop_per_s=flops / k_ms / 1e9,
                        share_of_bound=b_ms / k_ms, vs_library=k_ms / f_ms,
                        issued_flops=issued,
                        issued_tflop_per_s=issued / k_ms / 1e9,
                        f32_ms=f32_ms, f32_bound_ms=f32_bound,
                        f32_bound_by=f32_by)
        emit(dict(phase="kernel_time", card=smi, kernel="K4", shape=case[:6],
                  window=case[6], softcap=case[7], dtype="bfloat16",
                  **out[tag]))
        del q, k, v, qt, kt, vt, q32, k32, v32
        torch.cuda.empty_cache()
    torch.compiler.reset()
    return out


# ---------------------------------------------------------------------------
# the LM serving path: gemma2-2b prefill through K4, then greedy decode
# ---------------------------------------------------------------------------

def lm_config(get_config, dtype, backend="flash"):
    """gemma2-2b at its published widths (26 layers, d_model 2304, 8 query
    over 4 kv heads of 256, d_ff 9216, vocab 256 000, 4096 windows, soft
    caps 50 and 30), nothing cut."""
    return get_config("gemma2-2b").replace(dtype=dtype, attn_backend=backend)


def lm_weights(torch, model, cfg, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return model.init_params(gen, cfg)


def lm_tokens(torch, vocab, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, vocab, (LM_B, LM_L), generator=gen,
                         device="cuda")


def decode(torch, model, params, cfg, cache, logits, start, steps):
    """``steps`` greedy serve_steps after a prefill of ``start`` tokens;
    returns every step's logits."""
    out = []
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(steps):
        pos = torch.full((tok.shape[0],), start + i, device="cuda")
        logits, cache = model.serve_step(params, cfg, cache, tok, pos)
        out.append(logits)
        tok = torch.argmax(logits, -1)[:, None]
    return out


def lm_main_path(torch, model, cfg, params, tokens, counts,
                 layers=LM_LAYERS, phase="lm_main_path", inputs=None,
                 **extra):
    """prefill (B 2, L 8192, cache 8192 + 16; ``inputs`` the frontend's
    or encoder's embeddings, passed to ``prefill``) then 16 greedy decode
    steps, with every launch count at 0 just before: K4 must launch once
    per layer (``layers`` of them) in the prefill and never in decode; all
    logits finite.  Prints ``phase`` with ``extra``.  Returns the
    launches, the prefill's logits and the cache (decode wrote its slots
    from LM_L on)."""
    cache = model.init_cache(cfg, LM_B, LM_L + LM_NEW)
    torch.cuda.synchronize()
    counts.reset()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, cfg, cache, tokens,
                                  **(inputs or {}))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = counts.read()
    t0 = time.perf_counter()
    steps = decode(torch, model, params, cfg, cache, logits, LM_L, LM_NEW)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = counts.read()
    require(after_prefill == dict(K1=0, K2=0, K3=0, K4=layers, K5=0),
            f"{cfg.name} prefill launches {after_prefill}")
    require(launches == after_prefill,
            f"{cfg.name} decode launched {launches}")
    all_logits = torch.stack([logits] + steps)
    require(all_logits.shape == (LM_NEW + 1, LM_B, cfg.vocab),
            f"logits shape {tuple(all_logits.shape)}")
    require(bool(torch.isfinite(all_logits).all()),
            f"{cfg.name}: non-finite logits")
    emit(dict(phase=phase, arch=cfg.name, dtype=cfg.dtype,
              params=cfg.param_count(), batch=LM_B, prompt=LM_L,
              decode_steps=LM_NEW, launches=launches,
              first_prefill_s=prefill_s, decode_s=decode_s,
              tokens=torch.argmax(all_logits, -1).T.tolist(),
              logits_absmax=all_logits.abs().max().item(), **extra))
    return launches, logits, cache


@contextlib.contextmanager
def both_backends(model, record):
    """Inside the block every attention sub-block of the port's model
    (``model.attn_qkvo``, called by the model's own layer loop) runs
    through the flash kernel and through the xla branch on the same
    input; ``record`` gets (max |flash - xla|, max |xla|) for each layer
    in order, and the run goes on with the xla output."""
    orig = model.attn_qkvo

    def both(x, bp, cfg, positions, **kw):
        yf = orig(x, bp, cfg.replace(attn_backend="flash"), positions, **kw)
        yx = orig(x, bp, cfg.replace(attn_backend="xla"), positions, **kw)
        record.append(((yf - yx).float().abs().max().item(),
                       yx.float().abs().max().item()))
        return yx

    model.attn_qkvo = both
    try:
        yield
    finally:
        model.attn_qkvo = orig


#: the floating-point leaves of a block's cache: attention k and v, the
#: Mamba2 conv window and SSM state (positions are compared apart)
CACHE_LEAVES = ("k", "v", "conv", "state")


def cache_kv(cache, rows=slice(None)):
    """Every floating-point leaf of a cache, stacked units then the tail,
    in layer order, then an enc-dec model's encoder output, for the batch
    rows ``rows``."""
    return ([leaf[name][:, rows] for leaf in cache["stack"].values()
             for name in CACHE_LEAVES if name in leaf]
            + [leaf[name][rows] for leaf in cache["tail"].values()
               for name in CACHE_LEAVES if name in leaf]
            + ([cache["enc_out"][rows]] if "enc_out" in cache else []))


def prefill_drift(torch, model, cfg, params, tokens, seq_len, inputs=None):
    """The prefill through the flash kernel, then through the xla branch
    with ``both_backends`` on: each layer's flash-vs-xla difference on the
    xla run's own layer input, and the end-to-end max abs differences of
    the logits and the caches (k, v and an encoder output; the positions
    must be equal).  ``inputs`` go to both prefills.  Returns those with
    both runs' logits and caches."""
    layers = []
    res = {}
    for backend in ("flash", "xla"):
        c = cfg.replace(attn_backend=backend)
        cache = model.init_cache(c, tokens.shape[0], seq_len)
        with contextlib.ExitStack() as stack:
            if backend == "xla":
                stack.enter_context(both_backends(model, layers))
            logits, cache = model.prefill(params, c, cache, tokens,
                                          **(inputs or {}))
        torch.cuda.synchronize()
        res[backend] = (logits, cache)
    (lf, cf), (lx, cx) = res["flash"], res["xla"]
    for key in cf["stack"]:
        require(torch.equal(cf["stack"][key]["pos"], cx["stack"][key]["pos"]),
                "cache positions")
    return dict(
        layers=[e for e, _ in layers], layer_absmax=[m for _, m in layers],
        logits=(lf - lx).abs().max().item(),
        cache=max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(cache_kv(cf), cache_kv(cx))),
        logits_absmax=lx.abs().max().item(), runs=res)


def witness_arrays(np, tree, vocab):
    """The drift witness's weights and tokens, drawn with numpy so that
    the JAX package builds the same ones: for each leaf of ``tree`` (a
    nested dict read for its keys and shapes only), in sorted key order,
    zeros for the norms and N(0, 1) * scale in float32 otherwise (0.02 for
    the embeddings, fan_in^-0.5 for the rest, fan_in = shape[-2]); then
    WITNESS_B x WITNESS_L tokens.  Callers cast the non-norm leaves to
    bfloat16."""
    rng = np.random.default_rng(WITNESS_SEED)

    def draw(node):
        out = {}
        for key in sorted(node):
            val = node[key]
            shape = None if isinstance(val, dict) else tuple(val.shape)
            if shape is None:
                out[key] = draw(val)
            elif key.startswith("ln"):
                out[key] = np.zeros(shape, np.float32)
            else:
                scale = 0.02 if key in ("embed", "unembed") \
                    else shape[-2] ** -0.5
                out[key] = rng.standard_normal(shape, dtype=np.float32) \
                    * np.float32(scale)
        return out

    return draw(tree), rng.integers(0, vocab, (WITNESS_B, WITNESS_L))


def witness_config(get_config, reduced):
    return reduced(get_config("gemma2-2b"), head_dim=256, dtype="bfloat16")


def drift_witness(torch, np, model, convert, get_config, reduced):
    """The witness on the card: the port's kernel against its xla branch
    on the reference's witness inputs, layer by layer and end to end, held
    to WITNESS_RATIO times the reference's own drift (REF_DRIFT)."""
    cfg = witness_config(get_config, reduced)
    shapes = model.init_params(torch.Generator().manual_seed(0), cfg)
    arrays, toks = witness_arrays(np, shapes, cfg.vocab)
    params = convert.params_from_numpy(arrays, "cuda")
    params = tree_map(lambda k, t: t if k.startswith("ln")
                      else t.to(torch.bfloat16), params)
    tokens = torch.from_numpy(toks).cuda()
    d = prefill_drift(torch, model, cfg, params, tokens, WITNESS_L)
    d.pop("runs")
    emit(dict(phase="drift_witness", arch=cfg.name, head_dim=cfg.head_dim,
              dtype=cfg.dtype, batch=WITNESS_B, prompt=WITNESS_L, port=d,
              reference=REF_DRIFT, ratio=WITNESS_RATIO))
    require(max(d["layers"]) <= WITNESS_RATIO * max(REF_DRIFT["layers"])
            and d["logits"] <= WITNESS_RATIO * REF_DRIFT["logits"]
            and d["cache"] <= WITNESS_RATIO * REF_DRIFT["cache"],
            f"drift witness: port {d} against reference {REF_DRIFT}")


#: the SSD drift witness: zamba2-7b's SSD widths (P 64, N 64, chunk 128)
#: over 8 heads, B 2 sequences of 256 tokens, in bfloat16, drawn with
#: numpy from SSD_WITNESS_SEED (``ssd_witness_arrays``) so that the JAX
#: package builds the same inputs
SSD_WITNESS = dict(b=2, l=256, h=8, p=64, n=64, chunk=128)
SSD_WITNESS_SEED = 13
#: the reference's own bfloat16 spread between its jnp ``ssd_chunked``
#: (y_diag + y_off summed in float32, rounded once) and its drop-in
#: ``ssd_chunked_pallas`` (y_diag rounded to bf16 first) on the witness:
#: max |y difference| over max |y| (the JAX package on the CPU, Pallas in
#: interpret mode; recomputed by tests/test_torch_ssd_chunk.py).  Each
#: Mamba layer's kernel route is held within SSD_WITNESS_RATIO times it
#: of the plain route on the same input, as a share of the layer's
#: largest SSD output
REF_SSD_DRIFT = dict(y=0.03125, y_absmax=17.375, rel=0.0017985611921176314)
SSD_WITNESS_RATIO = 4.0


def ssd_witness_arrays(np):
    """The SSD witness's float32 inputs (callers cast xdt, B and C to
    bfloat16): x and B, C ~ N(0, 1); dt = softplus(N(0, 1) - 4.6) as the
    model's dt_bias gives; A = -linspace(1, 16, h); xdt = x dt, dA = dt A.
    Layout [b, l, h, .] as the model's."""
    w = SSD_WITNESS
    b, l, h, p, n = w["b"], w["l"], w["h"], w["p"], w["n"]
    rng = np.random.default_rng(SSD_WITNESS_SEED)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h), dtype=np.float32)
                         - np.float32(4.6))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    B = rng.standard_normal((b, l, 1, n), dtype=np.float32)
    C = rng.standard_normal((b, l, 1, n), dtype=np.float32)
    return dict(xdt=x * dt[..., None], dA=dt * A,
                B=np.broadcast_to(B, (b, l, h, n)).copy(),
                C=np.broadcast_to(C, (b, l, h, n)).copy())


def tree_map(fn, tree):
    """``fn(key, leaf)`` over a nested dict's leaves."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(k, v)
            for k, v in tree.items()}


def flash_vs_xla(torch, model, cfg, params, tokens):
    """gemma2-2b at full width, flash kernel against xla branch:

    * bfloat16 (B 2): each layer's attention output on the same input
      within LM_TOL_BF16_LAYER, printed beside each layer's largest
      output; the end-to-end differences printed;
    * float32 (B 1) on the bf16 weights upcast: logits and caches within
      LM_TOL_F32;
    * the bfloat16 prefills' first row against the float32 xla prefill
      (the truth): the kernel's path no farther than LM_TRUTH_RATIO times
      the xla path's, for the logits and for the caches."""
    bf = prefill_drift(torch, model, cfg, params, tokens, LM_L + LM_NEW)
    runs = bf.pop("runs")
    emit(dict(phase="flash_vs_xla_bf16", dtype=cfg.dtype, batch=LM_B,
              prompt=LM_L, tol_layer=LM_TOL_BF16_LAYER, **bf))
    require(max(bf["layers"]) <= LM_TOL_BF16_LAYER,
            f"flash vs xla per layer (bf16): {bf['layers']}")
    c32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda k, t: t.float(), params)
    f32 = prefill_drift(torch, model, c32, p32, tokens[:1], LM_L + LM_NEW)
    truth_logits, truth_cache = f32.pop("runs")["xla"]
    del p32
    emit(dict(phase="flash_vs_xla_f32", dtype="float32", batch=1,
              prompt=LM_L, tol=LM_TOL_F32, **f32))
    require(f32["logits"] <= LM_TOL_F32 and f32["cache"] <= LM_TOL_F32,
            f"flash vs xla prefill (float32): logits {f32['logits']}, "
            f"caches {f32['cache']} > {LM_TOL_F32}")
    dist = {}
    for backend, (logits, cache) in runs.items():
        dist[backend] = dict(
            logits=(logits[:1] - truth_logits).abs().max().item(),
            cache=max((a.float() - b).abs().max().item() for a, b in
                      zip(cache_kv(cache, slice(0, 1)),
                          cache_kv(truth_cache))))
    emit(dict(phase="bf16_against_f32", batch_row=0, prompt=LM_L,
              flash=dist["flash"], xla=dist["xla"], ratio=LM_TRUTH_RATIO))
    for what in ("logits", "cache"):
        require(dist["flash"][what] <= LM_TRUTH_RATIO * dist["xla"][what],
                f"bf16 {what}: flash {dist['flash'][what]} from float32, "
                f"xla {dist['xla'][what]}")
    del runs, truth_logits, truth_cache
    torch.cuda.empty_cache()


def decode_parity_small(torch, model, get_config, reduced):
    """On the card at a small size: reduced gemma2-2b (float32, flash
    backend) prefill of 128 tokens then 16 decode steps against the full
    forward over all 144, within 1e-3 (tests/test_decode_parity.py)."""
    cfg = reduced(get_config("gemma2-2b")).replace(attn_backend="flash")
    params = lm_weights(torch, model, cfg, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab, (2, 144), generator=gen,
                         device="cuda")
    h, _ = model.forward_hidden(params, cfg, toks)
    full = model.lm_logits(h, params, cfg)
    cache = model.init_cache(cfg, 2, 144)
    logits, cache = model.prefill(params, cfg, cache, toks[:, :128])
    errs = [(logits - full[:, 127]).abs().max().item()]
    for i in range(128, 144):
        logits, cache = model.serve_step(params, cfg, cache,
                                         toks[:, i:i + 1],
                                         torch.full((2,), i, device="cuda"))
        errs.append((logits - full[:, i]).abs().max().item())
    emit(dict(phase="decode_parity_small", max_abs_err=max(errs), tol=1e-3))
    require(max(errs) < 1e-3, f"decode parity {errs}")


@contextlib.contextmanager
def labelled(torch, owner, attr, label):
    """Inside the block ``owner.attr`` (a function the model calls
    through its module global) runs under
    ``torch.profiler.record_function(label)``."""
    orig = getattr(owner, attr)

    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return orig(*a, **kw)

    setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def range_kernels(evt):
    """(name, µs) of every device kernel launched inside a profiled CPU
    event and its children."""
    out = [(k.name, k.duration) for k in evt.kernels]
    for child in evt.cpu_children:
        out += range_kernels(child)
    return out


def by_part(kernels, parts):
    """ms of each part (name -> kernel-name substrings) over (name, µs)
    pairs: a kernel counts for the first part one of whose substrings its
    name contains."""
    split = dict.fromkeys(parts, 0.0)
    for name, us in kernels:
        low = name.lower()
        hit = next((p for p, subs in parts.items()
                    if any(sub in low for sub in subs)), None)
        if hit is not None:
            split[hit] += us / 1e3
    return split


def profile_ms(torch, fn, parts=None, ranges=None):
    """One call of ``fn`` under torch.profiler: summed device time of all
    kernels, launches, and the top kernels by device time (None when the
    profiler records no device activity).  With ``parts`` (name -> kernel
    name substrings), also the device ms of each part: a kernel counts
    for the first part one of whose substrings its name contains.  With
    ``ranges`` (label -> (owner, attribute) of a function the run calls),
    each such function runs under ``record_function(label)``, and the
    kernels launched inside it count for its label (``parts_ms[label]``)
    and for no part; the labels' own device annotations are not kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ranges = ranges or {}
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for label, (owner, attr) in ranges.items():
            stack.enter_context(labelled(torch, owner, attr, label))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    kernels = [(e.name, e.time_range.elapsed_us()) for e in events
               if e.device_type == DeviceType.CUDA and e.name not in ranges]
    by_name = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = dict(device_ms=(sum(us for _, us in kernels) / 1e3
                          if kernels else None),
               launches=len(kernels) if kernels else None,
               top_kernels_ms=[[n[:80], us / 1e3] for n, us in top])
    if parts is not None:
        split = by_part(by_name.items(), parts)
        inside = {label: [k for e in events
                          if e.device_type == DeviceType.CPU
                          and e.name == label for k in range_kernels(e)]
                  for label in ranges}
        for label, ks in inside.items():
            for part, ms in by_part(ks, parts).items():
                split[part] -= ms
            split[label] = sum(us for _, us in ks) / 1e3
        out["parts_ms"] = split if kernels else None
        if ranges:
            out["range_launches"] = {label: len(ks)
                                     for label, ks in inside.items()}
    return out


def time_lm(torch, model, cfg, params, tokens, smi):
    """Prefill ms (2 calls) and decode ms per step (16 steps), CUDA events
    after the main path's warm run; then one prefill and one decode step
    under the profiler, with the device busy share against those times."""
    cache = model.init_cache(cfg, LM_B, LM_L + LM_NEW)
    holder = {}

    def run_prefill():
        holder["logits"], _ = model.prefill(params, cfg, cache, tokens)

    prefill_ms = events_ms(torch, run_prefill, 2)

    def run_decode():
        decode(torch, model, params, cfg, cache, holder["logits"], LM_L,
               LM_NEW)

    decode_ms = events_ms(torch, run_decode, 1) / LM_NEW
    tok = torch.argmax(holder["logits"], -1)[:, None]
    pos = torch.full((LM_B,), LM_L, device="cuda")
    pre = profile_ms(torch, run_prefill)
    dec = profile_ms(torch, lambda: model.serve_step(params, cfg, cache,
                                                     tok, pos))
    for name, prof, wall in (("prefill", pre, prefill_ms),
                             ("decode_step", dec, decode_ms)):
        busy = None if prof["device_ms"] is None else prof["device_ms"] / wall
        emit(dict(phase="profile", card=smi, path=f"lm_{name}",
                  wall_ms=wall, device_busy_share=busy, **prof))
    rec = dict(prefill_ms=prefill_ms, prefill_tok_per_s=LM_B * LM_L
               / prefill_ms * 1e3, decode_ms_per_step=decode_ms,
               decode_tok_per_s=LM_B / decode_ms * 1e3,
               prefill_device_ms=pre["device_ms"],
               flash_share_of_prefill=None)
    flash = [ms for n, ms in pre["top_kernels_ms"] if "flash_fwd" in n]
    if flash and pre["device_ms"]:
        rec["flash_share_of_prefill"] = flash[0] / prefill_ms
    emit(dict(phase="lm_time", card=smi, arch=cfg.name, dtype=cfg.dtype,
              batch=LM_B, prompt=LM_L, **rec))
    model_flops_share(cfg, tokens.numel(), "prefill", prefill_ms, smi,
                      "lm_prefill")
    del cache, holder
    torch.cuda.empty_cache()
    return rec


def model_flops_share(cfg, n_tokens, kind, ms, smi, path):
    """Prints ``analysis.model_flops`` (6·N·D for a training round, 2·N·D
    for a prefill, N the active parameters) of a run an earlier phase
    timed, over what the card's bf16 peak does in its ``ms``."""
    from repro_torch.launch import analysis

    flops = analysis.model_flops(cfg, n_tokens, kind)
    emit(dict(phase="model_flops_share", card=smi, path=path, arch=cfg.name,
              kind=kind, tokens=n_tokens,
              active_params=analysis.active_param_count(cfg),
              model_flops=flops, ms=ms,
              share=flops / (ms * 1e-3 * BF16_FLOP_PER_S)))


def ssd_chunk_bound(cfg, batch, seq, esize):
    """Least time of K5 (the SSD chunk kernel) at ``cfg``'s widths over
    ``batch`` sequences of ``seq`` tokens, reckoned from
    repro/kernels/ssd_chunk/kernel.py: per (batch, head, chunk) of K rows,
    C.B^T and (L * C.B^T).x on the lower triangle the mask leaves
    (K(K+1)/2 entries) and the states (B * decay)^T.x in full.  Bytes in
    the model's dtypes (x, B, C and y_diag at ``esize`` bytes: x, B and C
    come from the conv, which casts back to the activations' dtype,
    repro/models/ssm.py:134, and dt is cast to it before x dt, :194; dA,
    the states and the decay in float32), each read or written once.

    ``bound_ms`` is the route's: in bfloat16 (esize 2) the tensor-core
    kernel's, the flops at BF16_FLOP_PER_S and B and C counted once per
    (batch, chunk, group), as their storage holds them (the model expands
    them over the heads by a stride-0 view); in float32 ``fp32_bound_ms``,
    the FP32-pipe kernel's, the flops at FP32_FLOP_PER_S and B and C
    counted per head, as that kernel's operands are shaped."""
    K, P, N, H, G = (cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.ssm_heads, cfg.ssm_groups)
    chunks = seq // K
    programs = batch * H * chunks
    tri = K * (K + 1) // 2
    flops = programs * (2 * tri * N + 2 * tri * P + 2 * N * P * K)
    per_program = esize * 2 * K * P + 4 * (K + N * P + 1)
    bc = esize * 2 * K * N
    fp32_bytes = programs * (per_program + bc)
    nbytes = programs * per_program + batch * chunks * G * bc
    fp32_ms = 1e3 * max(fp32_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    rec = dict(kernel="K5", arch=cfg.name, batch=batch, seq=seq,
               esize=esize, programs=programs, flops=flops, bytes=nbytes,
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               fp32_bytes=fp32_bytes, fp32_bound_ms=fp32_ms,
               fp32_bound_by=("bytes" if fp32_bytes / HBM_BYTES_PER_S
                              >= flops / FP32_FLOP_PER_S else "operations"))
    if esize == 4:
        rec.update(bytes=fp32_bytes, bound_ms=fp32_ms,
                   bound_by=rec["fp32_bound_by"])
    return rec


#: the tensor-core kernel's tiles (kernels/ssd_chunk/csrc/ssd_chunk_wgmma.cu:
#: kRows, kWgRows, kPP, kTerms, kWTerms): 128 chunk rows in two consumer
#: warpgroups of 64, the first over G's columns 0-63 and the second over
#: 0-127; P padded to 64; S in two bf16 terms, w o x in three
SSD_ROWS, SSD_WG_ROWS, SSD_PP, SSD_S_TERMS, SSD_W_TERMS = 128, 64, 64, 2, 3


def ssd_issued_flops(b, h, c, N, run):
    """Tensor-core flops the bf16 kernel issues for b * h * c chunks of
    state width N, ``run`` heads a block: per block G = C.B^T over the two
    warpgroups' 64 x 64 and 64 x 128 tiles and N padded to 64 or 128; per
    head y = S.x over those columns (P padded to 64) in SSD_S_TERMS terms,
    and states^T = (w o x)^T.B over all 128 rows in SSD_W_TERMS terms.
    Rows past K and columns past P or N are issued too."""
    NP = 64 if N <= 64 else 128
    blocks = b * c * -(-h // run)
    g = 2 * SSD_WG_ROWS * (64 + 128) * NP
    y = SSD_S_TERMS * 2 * SSD_WG_ROWS * SSD_PP * (64 + 128)
    st = SSD_W_TERMS * 2 * SSD_PP * NP * SSD_ROWS
    return blocks * g + b * h * c * (y + st)


# ---------------------------------------------------------------------------
# K5: the SSD chunk kernel against its plain version, and its numbers
# ---------------------------------------------------------------------------

#: (b, l, h, p, n, chunk): tests/test_kernel_ssd.py:30-33, K = 1, then the
#: main path's shapes: zamba2-7b (H 112, P 64, N 64) and mamba2-130m
#: (H 24, N 128) at B 2, L 8192
SSD_SMALL = [(1, 8, 1, 4, 4, 4), (2, 32, 3, 8, 4, 8), (1, 64, 2, 16, 8, 16),
             (2, 24, 2, 8, 16, 12), (2, 5, 3, 8, 4, 1)]
SSD_ZAMBA = (2, 8192, 112, 64, 64, 128)
SSD_MAMBA = (2, 8192, 24, 64, 128, 128)
#: shapes for the bf16 tensor-core kernel's edges, (case, options): ragged
#: K (64; 96 with L a multiple of it), P (40) and N (24: 48-byte rows),
#: N 128 over few heads, B and C with a nonzero head stride (one tile per
#: head, ``copied``), and dA with some positive entries (``rising``: L
#: taken directly, not from its factors)
SSD_EDGE = [((2, 512, 8, 64, 64, 64), {}), ((1, 384, 4, 64, 64, 96), {}),
            ((2, 256, 4, 40, 64, 128), {}), ((2, 256, 4, 64, 24, 128), {}),
            ((1, 256, 4, 64, 128, 128), {}),
            ((1, 256, 4, 64, 128, 128), dict(copied=True)),
            ((2, 256, 3, 64, 64, 128), dict(copied=True)),
            ((2, 512, 8, 64, 128, 128), dict(rising=True))]
#: every row's max |kernel - plain| over its largest plain element: y_diag
#: rows (one (b, h, c, k), over P) 1e-5 with float32 inputs and 1e-2
#: (one ulp of the row's largest element) with bfloat16 ones; states rows
#: (one (b, h, c, n), over P) 1e-5, always float32; decay 1e-6 relative
SSD_ROW_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SSD_STATE_TOL, SSD_DECAY_TOL = 1e-5, 1e-6


def ssd_inputs(torch, case, dtype, seed, copied=False, rising=False):
    """The model's operands on the card: xdt [b, l, h, p] and one group of
    B, C [b, l, 1, n] in ``dtype``, expanded over the heads with stride 0
    (``copied``: B, C [b, l, h, n], one tile per head); dA [b, l, h]
    float32 from dt = softplus(N(0, 1) - 4.6) (the model's dt_bias) and
    A = -linspace(1, 16, h) (its A_log), plus U(0, 0.02) when ``rising``
    (some entries then positive)."""
    b, l, h, p, n, _ = case
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    dt = torch.nn.functional.softplus(rand(b, l, h) - 4.6)
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    xdt = (rand(b, l, h, p) * dt[..., None]).to(dtype)
    if copied:
        B_, C_ = (rand(b, l, h, n).to(dtype) for _ in "BC")
    else:
        B_, C_ = (rand(b, l, 1, n).to(dtype).expand(b, l, h, n)
                  for _ in "BC")
    dA = dt * A
    if rising:
        dA = dA + 0.02 * torch.rand(b, l, h, generator=gen, device="cuda")
    return xdt, dA, B_, C_


def rows_rel(out, plain):
    """The largest, over rows (the last axis), of max |out - plain| over
    max |plain|."""
    err = (out.float() - plain.float()).abs().amax(-1)
    return (err / plain.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def ssd_errors(got, want):
    """(y_diag, states, decay) against another triple: the row bounds'
    measures and the largest y_diag difference."""
    (y, st, dec), (yp, stp, decp) = got, want
    return dict(y_row_rel_err=rows_rel(y, yp),
                states_row_rel_err=rows_rel(st, stp),
                decay_rel_err=((dec - decp).abs()
                               / decp.abs().clamp_min(1e-30)).max().item(),
                max_abs_err=(y.float() - yp.float()).abs().max().item())


def ssd_within(e, name):
    return (e["y_row_rel_err"] <= SSD_ROW_TOL[name]
            and e["states_row_rel_err"] <= SSD_STATE_TOL
            and e["decay_rel_err"] <= SSD_DECAY_TOL)


def check_ssd(torch, sops, sref):
    """Every case, float32 and bfloat16: the wrapper on the regrouped
    strided views (exactly one launch, on the route ``wgmma_route``
    chose, which each line states), the plain version on the same views,
    the row bounds above; in bfloat16 also the same bounds against
    ``ssd_chunk_tiled_ref``, the tensor-core kernel's own arithmetic in
    plain torch.  Returns the largest y_diag error at zamba2-7b's shape in
    bfloat16 (the main path's)."""
    worst = 0.0
    cases = [(c, {}) for c in SSD_SMALL + [SSD_ZAMBA, SSD_MAMBA]] + SSD_EDGE
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for i, (case, opts) in enumerate(cases):
            chunk = case[-1]
            views = [sops.regroup(t, chunk) for t in
                     ssd_inputs(torch, case, dtype, seed=400 + i, **opts)]
            route = "wgmma" if sops.wgmma_route(*views) else "simt"
            before = sops.ssd_chunk.launches
            before_w = sops.ssd_chunk.wgmma_launches
            got = sops.ssd_chunk(*views)
            torch.cuda.synchronize()
            launched = sops.ssd_chunk.launches - before
            launched_w = sops.ssd_chunk.wgmma_launches - before_w
            plain = sref.ssd_chunk_ref(*views)
            torch.cuda.synchronize()
            y, st, dec = got
            e = ssd_errors(got, plain)
            ok = (launched == 1 and launched_w == (route == "wgmma")
                  and y.shape == plain[0].shape and y.dtype == dtype
                  and st.shape == plain[1].shape
                  and dec.shape == plain[2].shape
                  and all(bool(torch.isfinite(t).all()) for t in got)
                  and ssd_within(e, name))
            tiled = {}
            if dtype == torch.bfloat16:
                et = ssd_errors(got, sref.ssd_chunk_tiled_ref(*views))
                tiled = {f"tiled_{k}": v for k, v in et.items()}
                ok = ok and ssd_within(et, name)
            emit(dict(phase="kernel_check", kernel="K5", shape=case, **opts,
                      dtype=name, route=route, launches=launched, **e,
                      y_row_tol=SSD_ROW_TOL[name],
                      states_row_tol=SSD_STATE_TOL, decay_tol=SSD_DECAY_TOL,
                      **tiled, y_absmax=plain[0].float().abs().max().item(),
                      decay_min=plain[2].min().item(), ok=ok))
            if not ok:
                raise AssertionError(f"SSD chunk kernel at {case} {opts} "
                                     f"{name} disagrees with its plain "
                                     "version or its tiled one")
            if case == SSD_ZAMBA and dtype == torch.bfloat16:
                require(route == "wgmma", "zamba2-7b's shape took the "
                        "FP32-pipe kernel")
                worst = e["max_abs_err"]
            del views, got, plain, y, st, dec
            torch.cuda.empty_cache()
    return worst


def time_ssd(torch, sops, sref, get_config, smi):
    """K5 in bfloat16 (the main path's dtype) at zamba2-7b's and
    mamba2-130m's shapes: the tensor-core kernel (the main path's route)
    and the FP32-pipe kernel through ``_ssd_chunk_simt``, in turns
    (tensor-core, FP32-pipe, FP32-pipe, tensor-core) over 10 calls each,
    and the plain version over 2, CUDA events after a warm call, beside
    the bound and the tensor-core flops the kernel issues.  No single
    PyTorch call computes this function, so there is no library time."""
    out = {}
    for arch, case in (("zamba2-7b", SSD_ZAMBA), ("mamba2-130m", SSD_MAMBA)):
        views = [sops.regroup(t, case[-1])
                 for t in ssd_inputs(torch, case, torch.bfloat16, seed=800)]
        require(sops.wgmma_route(*views), f"{arch}: not the wgmma route")
        turns = {"wgmma": [], "simt": []}
        for route in ("wgmma", "simt", "simt", "wgmma"):
            fn = sops.ssd_chunk if route == "wgmma" else sops._ssd_chunk_simt
            turns[route].append(events_ms(torch, lambda: fn(*views), 10))
        k_ms = sum(turns["wgmma"]) / 2
        simt_ms = sum(turns["simt"]) / 2
        p_ms = events_ms(torch, lambda: sref.ssd_chunk_ref(*views), 2)
        bnd = ssd_chunk_bound(get_config(arch), case[0], case[1], 2)
        b, l, h, _, n, K = case
        run = sops.head_run(b, h, l // K, True, torch.cuda
                            .get_device_properties(0).multi_processor_count)
        issued = ssd_issued_flops(b, h, l // K, n, run)
        out[arch] = dict(ms=k_ms, ms_turns=turns["wgmma"], simt_ms=simt_ms,
                         simt_ms_turns=turns["simt"], speedup=simt_ms / k_ms,
                         plain_ms=p_ms, bound_ms=bnd["bound_ms"],
                         bound_by=bnd["bound_by"],
                         share_of_bound=bnd["bound_ms"] / k_ms,
                         fp32_bound_ms=bnd["fp32_bound_ms"],
                         simt_share_of_fp32_bound=bnd["fp32_bound_ms"]
                         / simt_ms,
                         flops=bnd["flops"], bytes=bnd["bytes"],
                         achieved_gb_per_s=bnd["bytes"] / k_ms / 1e6,
                         heads_per_block=run, issued_flops=issued,
                         issued_tflop_per_s=issued / k_ms / 1e9,
                         library_ms=None)
        emit(dict(phase="kernel_time", card=smi, kernel="K5", arch=arch,
                  shape=case, dtype="bfloat16", **out[arch]))
        del views
        torch.cuda.empty_cache()
    return out


#: zamba2-7b's shared attention at the main path's prefill: D = 112 (the
#: kernel's DP = 128 build, columns 112..127 guarded), 32 heads, G = 1,
#: global, no soft-cap.  The plain version's [B, H, L, S] float32 scores
#: are 17 GB at B 2, H 32, L = S = 8192, so the check at full length
#: takes one batch row and 8 heads; a short case takes every head
ZAMBA_ATTN_CHECK = [(1, 8, 8, 8192, 8192, 112, None, 0.0, True),
                    (2, 32, 32, 256, 256, 112, None, 0.0, True)]
ZAMBA_ATTN = (2, 32, 32, 8192, 8192, 112, None, 0.0, True)


def time_flash_sdpa(torch, fops, fref, smi, arch, case, cut):
    """K4 (bf16) at an attention shape where SDPA computes the same
    function (is_causal, no soft-cap, no window; ``enable_gqa`` where
    query heads share kv heads): the kernel over 20 calls at ``case``;
    SDPA over 20 as the library yardstick; the plain version and the
    kernel at ``cut`` (``case``, or its first batch rows and heads where
    the plain version's scores would not fit)."""
    q, k, v = flash_inputs(torch, case, torch.bfloat16, seed=710)
    k_ms = events_ms(torch, lambda: fops.flash_mha(q, k, v), 20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = dict(enable_gqa=True) if case[1] != case[2] else {}

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa)

    lib_err = (sdpa().transpose(1, 2).float()
               - fops.flash_mha(q, k, v).float()).abs().max().item()
    lib_ms = events_ms(torch, sdpa, 20)
    qc, kc, vc = (x[:cut[0], :, :cut[1]] for x in (q, k, v))
    cut_ms = events_ms(torch, lambda: fops.flash_mha(qc, kc, vc), 5)
    plain_cut_ms = events_ms(torch, lambda: fref.flash_mha_ref(qc, kc, vc), 2)
    b_ms, b_by, flops = flash_bound(case, 2, BF16_FLOP_PER_S)
    issued = flash_issued_flops(case, FLASH_BM, FLASH_BN,
                                flash_product_dims(case[5]))
    rec = dict(ms=k_ms, library_ms=lib_ms,
               library="torch scaled_dot_product_attention (is_causal"
                       + (", enable_gqa)" if gqa else ")"),
               library_max_abs_err_vs_kernel=lib_err, bound_ms=b_ms,
               bound_by=b_by, flops=flops, tflop_per_s=flops / k_ms / 1e9,
               share_of_bound=b_ms / k_ms, vs_library=k_ms / lib_ms,
               issued_flops=issued, issued_tflop_per_s=issued / k_ms / 1e9,
               cut_shape=cut[:6], ms_at_cut=cut_ms, plain_ms_at_cut=plain_cut_ms)
    emit(dict(phase="kernel_time", card=smi, kernel="K4", arch=arch,
              shape=case[:6], dtype="bfloat16", **rec))
    del q, k, v, qt, kt, vt, qc, kc, vc
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the Mamba2 serving path: zamba2-7b prefill through K5 and K4, then decode
# ---------------------------------------------------------------------------

#: zamba2-7b: 68 Mamba2 layers (13 units of five plus a tail of three) and
#: 13 invocations of the shared attention block
ZAMBA_MAMBA, ZAMBA_ATTN_LAYERS = 68, 13


def zamba_config(get_config, dtype):
    """zamba2-7b at its published widths and depth (81 layers, d_model
    3584, 112 SSD heads of P 64 with N 64 and chunk 128, one shared
    attention block of 32 heads of 112 and d_ff 14336, vocab 32 000),
    nothing cut."""
    return get_config("zamba2-7b").replace(dtype=dtype, attn_backend="flash")


def zamba_main_path(torch, model, cfg, params, tokens, counts):
    """prefill (B 2, L 8192, cache 8192 + 16) then 16 greedy decode steps,
    with every launch count at 0 just before: K5 must launch once per
    Mamba2 layer and K4 once per shared-attention invocation in the
    prefill, neither in decode; all logits finite."""
    cache = model.init_cache(cfg, LM_B, LM_L + LM_NEW)
    torch.cuda.synchronize()
    counts.reset()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, cfg, cache, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = counts.read()
    k5_wgmma = counts.k5_wgmma()
    t0 = time.perf_counter()
    steps = decode(torch, model, params, cfg, cache, logits, LM_L, LM_NEW)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = counts.read()
    require(after_prefill == dict(K1=0, K2=0, K3=0, K4=ZAMBA_ATTN_LAYERS,
                                  K5=ZAMBA_MAMBA),
            f"prefill launches {after_prefill}")
    require(k5_wgmma == ZAMBA_MAMBA and counts.k5_wgmma() == k5_wgmma,
            f"{k5_wgmma} of the prefill's {ZAMBA_MAMBA} K5 launches on the "
            "tensor-core route (the rest on the FP32-pipe kernel)")
    require(launches == after_prefill, f"decode launched {launches}")
    all_logits = torch.stack([logits] + steps)
    require(all_logits.shape == (LM_NEW + 1, LM_B, cfg.vocab),
            f"logits shape {tuple(all_logits.shape)}")
    require(bool(torch.isfinite(all_logits).all()), "non-finite logits")
    emit(dict(phase="zamba_main_path", arch=cfg.name, dtype=cfg.dtype,
              params=cfg.param_count(), batch=LM_B, prompt=LM_L,
              decode_steps=LM_NEW, launches=launches,
              k5_routes=dict(wgmma=k5_wgmma, simt=ZAMBA_MAMBA - k5_wgmma),
              first_prefill_s=prefill_s, decode_s=decode_s,
              tokens=torch.argmax(all_logits, -1).T.tolist(),
              logits_absmax=all_logits.abs().max().item()))
    del cache, all_logits, steps
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def ssd_routes(ssm, sops, record=None, plain=False):
    """Inside the block every Mamba2 layer of the port's model (its
    ``ssm.ssd_ops.ssd_chunked`` call, made by the model's own layer loop)
    takes the plain route (``plain=True``), or with ``record`` runs
    through the kernel and through the plain route on the same input:
    ``record`` gets, per layer in order, max |y kernel - y plain|, max |y
    plain| and max |final state difference|, and the run goes on with the
    kernel's output."""
    orig = ssm.ssd_ops

    def both(*args, **kw):
        yk, fk = sops.ssd_chunked(*args, **kw)
        yp, fp = sops.ssd_chunked_plain(*args, **kw)
        record.append(((yk.float() - yp.float()).abs().max().item(),
                       yp.float().abs().max().item(),
                       (fk - fp).abs().max().item()))
        return yk, fk

    route = sops.ssd_chunked_plain if plain else both
    ssm.ssd_ops = types.SimpleNamespace(ssd_chunked=route)
    try:
        yield
    finally:
        ssm.ssd_ops = orig


def ssd_vs_plain(torch, model, ssm, sops, cfg, params, tokens):
    """zamba2-7b at full width, the SSD kernel route against the plain
    route (the same scan with the plain intra-chunk block):

    * bfloat16 (B 2): each Mamba2 layer's SSD output on the same input,
      as a share of the layer's largest output, within SSD_WITNESS_RATIO
      times the reference's own spread (REF_SSD_DRIFT["rel"]);
    * float32 (B 1, the bf16 weights upcast): the prefill's logits and
      every cache leaf within LM_TOL_F32, kernel route against plain."""
    layers = []
    cache = model.init_cache(cfg, LM_B, LM_L + LM_NEW)
    with ssd_routes(ssm, sops, record=layers):
        model.prefill(params, cfg, cache, tokens)
    torch.cuda.synchronize()
    del cache
    rel = [e / m for e, m, _ in layers]
    bound = SSD_WITNESS_RATIO * REF_SSD_DRIFT["rel"]
    emit(dict(phase="ssd_vs_plain_bf16", dtype=cfg.dtype, batch=LM_B,
              prompt=LM_L, layers=len(layers),
              y_diff=[e for e, _, _ in layers],
              y_absmax=[m for _, m, _ in layers], rel=rel,
              state_diff=[s for _, _, s in layers], bound_rel=bound,
              reference=REF_SSD_DRIFT))
    require(len(layers) == ZAMBA_MAMBA, f"{len(layers)} Mamba2 layers")
    require(max(rel) <= bound, f"SSD kernel vs plain per layer (bf16): "
            f"{max(rel)} > {bound}")
    c32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda k, t: t.float(), params)
    runs = {}
    for route in ("kernel", "plain"):
        cache = model.init_cache(c32, 1, LM_L + LM_NEW)
        with contextlib.ExitStack() as stack:
            if route == "plain":
                stack.enter_context(ssd_routes(ssm, sops, plain=True))
            logits, cache = model.prefill(p32, c32, cache, tokens[:1])
        torch.cuda.synchronize()
        runs[route] = (logits, cache)
    del p32
    (lk, ck), (lp, cp) = runs["kernel"], runs["plain"]
    leaves = list(zip(cache_kv(ck), cache_kv(cp)))
    f32 = dict(logits=(lk - lp).abs().max().item(),
               cache=max((a.float() - b.float()).abs().max().item()
                         for a, b in leaves),
               logits_absmax=lp.abs().max().item())
    emit(dict(phase="ssd_vs_plain_f32", dtype="float32", batch=1,
              prompt=LM_L, tol=LM_TOL_F32, **f32))
    require(f32["logits"] <= LM_TOL_F32 and f32["cache"] <= LM_TOL_F32,
            f"SSD kernel vs plain prefill (float32): {f32}")
    del runs, leaves, lk, ck, lp, cp
    torch.cuda.empty_cache()


def zamba_parity_small(torch, model, get_config, reduced):
    """On the card at a small size: reduced zamba2-7b (float32, flash
    backend; Mamba2 chunk 8) prefill of 128 tokens then 16 decode steps
    against the full forward over all 144, within 1e-3
    (tests/test_decode_parity.py, family hybrid_shared)."""
    cfg = reduced(get_config("zamba2-7b")).replace(attn_backend="flash")
    params = lm_weights(torch, model, cfg, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(8)
    toks = torch.randint(0, cfg.vocab, (2, 144), generator=gen,
                         device="cuda")
    h, _ = model.forward_hidden(params, cfg, toks)
    full = model.lm_logits(h, params, cfg)
    cache = model.init_cache(cfg, 2, 144)
    logits, cache = model.prefill(params, cfg, cache, toks[:, :128])
    errs = [(logits - full[:, 127]).abs().max().item()]
    for i in range(128, 144):
        logits, cache = model.serve_step(params, cfg, cache,
                                         toks[:, i:i + 1],
                                         torch.full((2,), i, device="cuda"))
        errs.append((logits - full[:, i]).abs().max().item())
    emit(dict(phase="zamba_parity_small", max_abs_err=max(errs), tol=1e-3))
    require(max(errs) < 1e-3, f"zamba decode parity {errs}")


#: kernel-name substrings of the zamba2-7b profile's parts
ZAMBA_PARTS = {"K5": ("ssd_chunk_wgmma", "ssd_chunk_kernel"),
               "K4": ("flash_fwd",),
               "cublas": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
               "inter_chunk_addcmul": ("addcmul",),
               "conv": ("conv", "cudnn")}


def time_serve(torch, model, cfg, params, tokens, smi, tag, parts,
               inputs=None, ranges=None):
    """Prefill ms (2 calls) and decode ms per step (16 steps), CUDA events
    after the main path's warm run; one prefill and one decode step under
    the profiler, with the device busy share and the device time of the
    ``parts`` (name -> kernel-name substrings, first match wins), of the
    ``ranges`` (``profile_ms``) and of the rest.  ``inputs`` go to the
    prefills.  Prints ``profile`` lines ``{tag}_prefill`` and
    ``{tag}_decode_step`` and the ``{tag}_time`` line."""
    cache = model.init_cache(cfg, LM_B, LM_L + LM_NEW)
    holder = {}

    def run_prefill():
        holder["logits"], _ = model.prefill(params, cfg, cache, tokens,
                                            **(inputs or {}))

    prefill_ms = events_ms(torch, run_prefill, 2)

    def run_decode():
        decode(torch, model, params, cfg, cache, holder["logits"], LM_L,
               LM_NEW)

    decode_ms = events_ms(torch, run_decode, 1) / LM_NEW
    tok = torch.argmax(holder["logits"], -1)[:, None]
    pos = torch.full((LM_B,), LM_L, device="cuda")
    pre = profile_ms(torch, run_prefill, parts=parts, ranges=ranges)
    dec = profile_ms(torch, lambda: model.serve_step(params, cfg, cache,
                                                     tok, pos),
                     parts=parts, ranges=ranges)
    for name, prof, wall in (("prefill", pre, prefill_ms),
                             ("decode_step", dec, decode_ms)):
        busy = None if prof["device_ms"] is None else prof["device_ms"] / wall
        rest = None if prof["parts_ms"] is None else \
            prof["device_ms"] - sum(prof["parts_ms"].values())
        emit(dict(phase="profile", card=smi, path=f"{tag}_{name}",
                  wall_ms=wall, device_busy_share=busy, rest_ms=rest,
                  **prof))
    rec = dict(prefill_ms=prefill_ms, prefill_tok_per_s=LM_B * LM_L
               / prefill_ms * 1e3, decode_ms_per_step=decode_ms,
               decode_tok_per_s=LM_B / decode_ms * 1e3,
               prefill_device_ms=pre["device_ms"],
               prefill_shares=({k: v / prefill_ms
                                for k, v in pre["parts_ms"].items()}
                               if pre["parts_ms"] else None))
    emit(dict(phase=f"{tag}_time", card=smi, arch=cfg.name,
              dtype=cfg.dtype, batch=LM_B, prompt=LM_L, **rec))
    model_flops_share(cfg, tokens.numel(), "prefill", prefill_ms, smi,
                      f"{tag}_prefill")
    del cache, holder
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 3e: the fault and stale FL path, K2 on it
# ---------------------------------------------------------------------------

def fault_main_path(torch, train, staleness, counts):
    """``FAULT_FLAGS`` with the kernel (K2 once a round, nothing else),
    against the same flags through the two matvecs; the conservation law;
    then every update dropped (K2's guard on the path)."""
    parser = train.build_parser()
    counts.reset()
    t0 = time.perf_counter()
    state_k, hist_k, _ = train.run(
        parser.parse_args(FAULT_FLAGS + ["--use-kernel"]))
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = counts.read()
    losses = [h["loss"] for h in hist_k]
    require(len(hist_k) == 64, f"{len(hist_k)} rounds")
    require(launches == dict(K1=0, K2=64, K3=0, K4=0, K5=0),
            f"fault path launches {launches}")
    require(all(math.isfinite(v) for v in losses), f"losses {losses}")
    require(bool(torch.isfinite(state_k.global_tr).all()),
            "fault path global not finite")

    state_p, hist_p, _ = train.run(parser.parse_args(FAULT_FLAGS))
    torch.cuda.synchronize()
    require(counts.read() == launches, "the two-matvec run launched")
    series = {}
    for key in ("n_active", "n_dropped", "n_rejected", "n_stale"):
        series[key] = [h[key] for h in hist_k]
        require(series[key] == [h[key] for h in hist_p],
                f"{key} histories differ")
    stale_err = max(abs(a["mean_staleness"] - b["mean_staleness"])
                    for a, b in zip(hist_k, hist_p))
    require(stale_err <= 1e-6, f"mean_staleness differs by {stale_err}")
    diff = (state_k.global_tr - state_p.global_tr).abs().max().item()
    require(diff <= 1e-4, f"kernel vs plain global differ by {diff}")
    # geometric delays are >= 1: every computed update enters the ring
    pending = staleness.pending_count(state_k.stale).item()
    require(sum(series["n_active"]) == sum(series["n_stale"]) + pending,
            "conservation: sum(n_active) != sum(n_stale) + pending")
    require(sum(series["n_dropped"]) > 0 and sum(series["n_stale"]) > 0,
            "the path dropped or delivered nothing late")
    emit(dict(phase="fault_main_path", rounds=64, m=M_MAIN, n=N_MAIN,
              tau_max=TAU_MAX, launches=launches, wall_s_kernel=wall_k,
              first_loss=losses[0], last_loss=losses[-1],
              **{f"sum_{k}": sum(v) for k, v in series.items()},
              pending=pending, kernel_vs_plain_global=diff,
              mean_staleness_err=stale_err))

    args = parser.parse_args(DROP_ALL_FLAGS + ["--use-kernel"])
    g0 = train.setup(args, torch.device("cuda"))["state"].global_tr
    counts.reset()
    state_d, hist_d, _ = train.run(args)
    torch.cuda.synchronize()
    dropped = counts.read()
    require(dropped == dict(K1=0, K2=64, K3=0, K4=0, K5=0),
            f"all-dropped launches {dropped}")
    require(all(h["n_dropped"] == h["n_active"] for h in hist_d),
            "all-dropped: n_dropped != n_active")
    require(sum(h["n_active"] for h in hist_d) > 0, "nobody computed")
    require(torch.equal(state_d.global_tr, g0),
            "all-dropped: the global moved")
    emit(dict(phase="fault_all_dropped", rounds=64, launches=dropped,
              sum_n_dropped=sum(h["n_dropped"] for h in hist_d),
              global_bit_exact=True))
    return launches


def nan_witness(torch, train, engine, faults, federated, prng, counts,
                sanitize):
    """One client's images NaN in the device store and an all-ones trace
    (every client active every round), NAN_ROUNDS chunked rounds at full
    width through the upload kernel.  Sanitized, the client is rejected
    every round and the global stays finite; unsanitized (the negative
    control), the global turns non-finite."""
    parser = train.build_parser()
    args = parser.parse_args(MAIN_FLAGS + ["--use-kernel"])
    train.resolve_flags(args)
    dev = torch.device("cuda")
    rng = prng.PRNGKey(args.seed, dev)
    params, loss_fn, ds, base_p, _, _ = train.build_image_task(args, rng,
                                                               dev)
    fl = engine.FLConfig(m=args.m, s=args.s, eta_l=args.eta_l,
                         eta_g=args.eta_g, strategy=args.strategy,
                         use_kernel=True, flat_state=True)
    fc = faults.FaultCfg(trace=True, sanitize=sanitize)
    trace = torch.ones((NAN_ROUNDS, args.m), device=dev)
    state = engine.init_fl_state(
        rng, fl, params, fault=faults.init_fault_state(fc, trace=trace))
    from repro_torch.core.availability import AvailabilityCfg
    round_fn = engine.make_round_fn(
        fl, loss_fn, {}, AvailabilityCfg(kind=args.dynamics,
                                         gamma=args.gamma),
        base_p, fault_cfg=fc)
    store = ds.device_store(dev)
    rows = store["idx"][0, :int(store["counts"][0])]
    store["arrays"]["images"][rows] = float("nan")
    init, sample = federated.make_device_sampler(args.m, args.s, args.batch)
    key = prng.PRNGKey(args.seed + 1, dev)
    counts.reset()
    state, hist = engine.run_rounds(
        state, round_fn, None, NAN_ROUNDS, chunk_rounds=NAN_ROUNDS,
        sample_fn=sample, store=store, data_key=key,
        sampler_state=init(store, key))
    torch.cuda.synchronize()
    launched = counts.read()
    finite = bool(torch.isfinite(state.global_tr).all())
    require(launched == dict(K1=0, K2=NAN_ROUNDS, K3=0, K4=0, K5=0),
            f"NaN witness launches {launched}")
    require(all(h["n_active"] == args.m for h in hist),
            "the all-ones trace did not hold every client active")
    if sanitize:
        require(all(h["n_rejected"] == 1.0 for h in hist),
                f"n_rejected {[h['n_rejected'] for h in hist]}")
        require(all(math.isfinite(h["loss"]) for h in hist), "loss")
        require(finite, "sanitized global not finite")
    else:
        require(not finite, "negative control: the NaN did not reach the "
                "global, so the witness proves nothing")
    emit(dict(phase="nan_witness", sanitize=sanitize, rounds=NAN_ROUNDS,
              m=args.m, launches=launched,
              n_rejected=[h["n_rejected"] for h in hist],
              global_finite=finite))


def time_fault_path(torch, train, engine, federated, prng, staleness, smi):
    """ms per round of the fault and stale path with K2 and with the two
    matvecs (CUDA events, in turns), a profiler breakdown of one chunk,
    and the device ms of one ``step_buffer`` at the path's ring
    ([4, 100, 27 370] float32, 43.8 MB) in a CUDA graph."""
    runs = []
    for use_kernel in (True, False, False, True):
        r = time_rounds(torch, train, engine, federated, prng, use_kernel,
                        flags=FAULT_FLAGS)
        runs.append(r)
        emit(dict(phase="fault_round_time", card=smi, use_kernel=use_kernel,
                  round_ms=r["round_ms"], rounds_per_s=r["rounds_per_s"]))
    round_ms = (runs[0]["round_ms"] + runs[3]["round_ms"]) / 2
    emit(dict(phase="profile", card=smi, path="fault_stale", use_kernel=True,
              **profile_chunk(torch, runs[3], round_ms)))
    # the round reads nothing on the host: one chunk with every
    # synchronizing call an error (the faults' draws, the ring's slot
    # indices and the discount all stay on the card)
    r = runs[3]
    torch.cuda.set_sync_debug_mode("error")
    r["state"], r["ss"], _ = r["chunk"](r["state"], r["ss"], r["store"],
                                        r["key"])
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    state = r["state"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    defer = (torch.rand(M_MAIN, generator=gen, device="cuda") < 0.3).float()
    d = torch.randint(1, TAU_MAX + 1, (M_MAIN,), generator=gen,
                      device="cuda", dtype=torch.int32)
    G = torch.randn(M_MAIN, N_MAIN, generator=gen, device="cuda")
    step_ms = graph_ms(torch, lambda i: staleness.step_buffer(
        state.stale, state.t, defer, d, G), 16)
    ring_bytes = 4 * TAU_MAX * M_MAIN * N_MAIN
    emit(dict(phase="step_buffer_time", card=smi, ms=step_ms,
              ring_bytes=ring_bytes,
              bound_ms=1e3 * (2 * ring_bytes + 4 * M_MAIN * N_MAIN)
              / HBM_BYTES_PER_S))
    del runs, G
    torch.cuda.empty_cache()
    return round_ms


# ---------------------------------------------------------------------------
# phase 3f: the ten strategies on the FL path, epoch sampling, resume
# ---------------------------------------------------------------------------

STRATEGIES = ("fedawe", "fedawe_m", "fedavg_active", "fedavg_all",
              "fedavg_known_p", "fedau", "f3ast", "mifa", "fedvarp", "fedar")
#: FedAU's interval state and the three [m, N] memories, held under faults
FAULT_STRATEGIES = ("fedau", "mifa", "fedvarp", "fedar")
#: rounds of each strategy's run, one chunk of 16 (32 before phase 3n, cut
#: so that the whole script stays near 1 000 s)
STRAT_ROUNDS = 16


def with_flags(flags, **kv):
    """``flags`` with ``--key value`` set for each keyword (``chunk_rounds``
    is ``--chunk-rounds``), replaced where present, else appended."""
    out = list(flags)
    for k, v in kv.items():
        opt = "--" + k.replace("_", "-")
        if opt in out:
            out[out.index(opt) + 1] = str(v)
        else:
            out += [opt, str(v)]
    return out


def strategies_main_path(torch, train, strategies, counts, smi):
    """Each of the ten strategies for STRAT_ROUNDS rounds of the main
    path's flags with ``--use-kernel``, every count at 0 just before each:
    K1 once a round for FedAWE and FedAWE-M and no launch for the
    baselines, every loss finite, the same ``n_active`` history for all
    ten, no client stack for a stateless strategy, and each run's peak
    allocated memory."""
    parser = train.build_parser()
    n_active, launches = None, {}
    for name in STRATEGIES:
        args = parser.parse_args(
            with_flags(MAIN_FLAGS, strategy=name, rounds=STRAT_ROUNDS)
            + ["--use-kernel"])
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts.reset()
        state, hist, final = train.run(args)
        torch.cuda.synchronize()
        launches[name] = counts.read()
        strat = strategies.get_strategy(name)
        k1 = STRAT_ROUNDS if strat.stateful_clients else 0
        require(launches[name] == dict(K1=k1, K2=0, K3=0, K4=0, K5=0),
                f"{name} launches {launches[name]}")
        losses = [h["loss"] for h in hist]
        require(len(hist) == STRAT_ROUNDS
                and all(math.isfinite(v) for v in losses),
                f"{name} losses {losses}")
        require(state.global_tr.shape == (N_MAIN,)
                and bool(torch.isfinite(state.global_tr).all()),
                f"{name}: final global not finite of shape [N]")
        require((state.clients_tr is None) != strat.stateful_clients,
                f"{name}: client stack {state.clients_tr is not None}")
        series = [h["n_active"] for h in hist]
        n_active = n_active or series
        require(series == n_active, f"{name}: n_active history differs")
        extra = state.extra.values() if isinstance(state.extra, dict) else ()
        memory = [v for v in extra if v.shape == (M_MAIN, N_MAIN)]
        require(len(memory) == int(strat.memory_aided)
                and all(bool(torch.isfinite(v).all()) for v in memory),
                f"{name}: [m, N] memory {[tuple(v.shape) for v in memory]}")
        peak = torch.cuda.max_memory_allocated()
        emit(dict(phase="strategy_main_path", card=smi, strategy=name,
                  rounds=STRAT_ROUNDS, m=M_MAIN, n=N_MAIN,
                  launches=launches[name], first_loss=losses[0],
                  last_loss=losses[-1], final_eval_acc=final["eval_acc"],
                  client_stack=state.clients_tr is not None,
                  memory_mb=sum(v.numel() * 4 for v in memory) / 1e6,
                  peak_allocated_mb=peak / 1e6,
                  peak_above_start_mb=(peak - before) / 1e6))
        del state
    require(0 < sum(n_active) < STRAT_ROUNDS * M_MAIN, f"n_active {n_active}")
    return launches


def strategies_fault_path(torch, train, staleness, counts, smi):
    """FAULT_STRATEGIES under FAULT_FLAGS (with ``--use-kernel``, which a
    baseline ignores): no launch at all, every loss and the global finite,
    and sum(n_active) == sum(n_stale) + the updates still pending."""
    parser = train.build_parser()
    for name in FAULT_STRATEGIES:
        args = parser.parse_args(
            with_flags(FAULT_FLAGS, strategy=name, rounds=STRAT_ROUNDS)
            + ["--use-kernel"])
        counts.reset()
        state, hist, _ = train.run(args)
        torch.cuda.synchronize()
        launched = counts.read()
        require(launched == dict(K1=0, K2=0, K3=0, K4=0, K5=0),
                f"{name} fault path launches {launched}")
        require(all(math.isfinite(h["loss"]) for h in hist)
                and bool(torch.isfinite(state.global_tr).all()),
                f"{name} under faults: not finite")
        sums = {k: sum(h[k] for h in hist)
                for k in ("n_active", "n_stale", "n_dropped", "n_rejected")}
        pending = staleness.pending_count(state.stale).item()
        require(sums["n_active"] == sums["n_stale"] + pending,
                f"{name}: sum(n_active) != sum(n_stale) + pending")
        require(sums["n_dropped"] > 0 and sums["n_stale"] > 0,
                f"{name}: nothing dropped or delivered late")
        emit(dict(phase="strategy_fault_path", card=smi, strategy=name,
                  rounds=STRAT_ROUNDS, launches=launched, pending=pending,
                  last_loss=hist[-1]["loss"],
                  **{f"sum_{k}": v for k, v in sums.items()}))
        del state


def restore_artifact(torch, train, federated, io, args, path):
    """``(state, sampler carry)`` of the resumable artifact ``path``,
    restored into fresh templates of ``args``' run."""
    dev = torch.device("cuda")
    parts = train.setup(args, dev)
    store = parts["ds"].device_store(dev)
    init, _ = federated.make_device_sampler(args.m, args.s, args.batch,
                                            mode=args.sampling)
    return io.restore_run_state(path, parts["state"],
                                init(store, parts["data_key"]))


def require_same_run(torch, a, b, what):
    """Two restored artifacts: τ, t, the key and the sampler carry
    bit-equal, the global within 1e-4 (cuDNN's convolution backward need
    not be deterministic); returns the global's difference."""
    (sa, ssa), (sb, ssb) = a, b
    for k in ("tau", "t", "rng"):
        require(torch.equal(getattr(sa, k), getattr(sb, k)),
                f"{what}: {k} differs")
    require(set(ssa) == set(ssb) == {"perm", "cursor", "epoch", "key"}
            and all(torch.equal(ssa[k], ssb[k]) for k in ssa),
            f"{what}: sampler carry differs")
    diff = (sa.global_tr - sb.global_tr).abs().max().item()
    require(diff <= 1e-4, f"{what}: globals differ by {diff}")
    return diff


def epoch_and_resume(torch, train, federated, io, smi):
    """Epoch sampling, chunked against the host loop, for FedAWE and MIFA;
    then FedVARP under epoch sampling for 2 x STRAT_ROUNDS rounds through
    ``--resume P --ckpt-every STRAT_ROUNDS``, once straight and once
    stopped at STRAT_ROUNDS and restarted.  Each run's final carry is read
    back from its own artifact."""
    import tempfile

    parser = train.build_parser()
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("fedawe", "mifa"):
            runs = {}
            for k in (16, 0):
                path = os.path.join(tmp, f"{name}-{k}")
                args = parser.parse_args(with_flags(
                    MAIN_FLAGS, strategy=name, rounds=STRAT_ROUNDS,
                    sampling="epoch", chunk_rounds=k, resume=path,
                    ckpt_every=STRAT_ROUNDS) + ["--use-kernel"])
                _, hist, _ = train.run(args)
                runs[k] = ([h["n_active"] for h in hist], restore_artifact(
                    torch, train, federated, io, args, path))
            require(runs[16][0] == runs[0][0],
                    f"{name} epoch: n_active differs chunked vs host loop")
            diff = require_same_run(torch, runs[16][1], runs[0][1],
                                    f"{name} epoch chunked vs host loop")
            epochs = runs[16][1][1]["epoch"]
            require(int(epochs.max()) >= 1,
                    f"{name} epoch: no client finished an epoch")
            emit(dict(phase="epoch_sampling", card=smi, strategy=name,
                      rounds=STRAT_ROUNDS, chunked_vs_host_global=diff,
                      epochs_min=int(epochs.min()),
                      epochs_max=int(epochs.max()),
                      sum_n_active=sum(runs[16][0])))

        T = 2 * STRAT_ROUNDS
        flags = with_flags(MAIN_FLAGS, strategy="fedvarp", sampling="epoch",
                           ckpt_every=STRAT_ROUNDS)
        straight = os.path.join(tmp, "straight")
        args = parser.parse_args(with_flags(flags, rounds=T,
                                            resume=straight))
        _, hist_s, _ = train.run(args)
        stopped = os.path.join(tmp, "stopped")
        train.run(parser.parse_args(with_flags(flags, rounds=STRAT_ROUNDS,
                                               resume=stopped)))
        _, hist_r, _ = train.run(parser.parse_args(with_flags(
            flags, rounds=T, resume=stopped)))
        require(len(hist_r) == T - STRAT_ROUNDS
                and [h["n_active"] for h in hist_r]
                == [h["n_active"] for h in hist_s[STRAT_ROUNDS:]],
                "resume: n_active differs from the straight run")
        a = restore_artifact(torch, train, federated, io, args, straight)
        b = restore_artifact(torch, train, federated, io, args, stopped)
        require(int(a[0].t) == int(b[0].t) == T, "resume: round counts")
        diff = require_same_run(torch, a, b, "resume")
        emit(dict(phase="resume", card=smi, strategy="fedvarp",
                  sampling="epoch",
                  rounds=T, stopped_at=STRAT_ROUNDS, resumed_vs_straight=diff,
                  memory_diff=(a[0].extra["y"] - b[0].extra["y"]).abs().max()
                  .item()))


def time_strategies(torch, train, engine, federated, smi):
    """ms per round of each strategy's chunked path with ``--use-kernel``,
    CUDA events over one chunk at a time, the ten in three turns (forward,
    backward, forward; the host's pace drifts within a call, so each
    strategy's median is compared); a profiler breakdown of one chunk
    of FedAvg and FedVARP;
    then one chunk of each, and one of MIFA under epoch sampling, under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read inside a
    round)."""
    runs = {name: chunk_setup(torch, train, engine, federated, with_flags(
        MAIN_FLAGS, strategy=name) + ["--use-kernel"]) for name in STRATEGIES}
    turns = {name: [] for name in STRATEGIES}
    for order in (STRATEGIES, STRATEGIES[::-1], STRATEGIES):
        for name in order:
            turns[name].append(chunks_ms(torch, runs[name], 1))
    median = {name: statistics.median(t) for name, t in turns.items()}
    for name in STRATEGIES:
        emit(dict(phase="strategy_round_time", card=smi, strategy=name,
                  round_ms_turns=turns[name], round_ms=median[name],
                  over_fedawe=median[name] / median["fedawe"]))
    for name in ("fedavg_active", "fedvarp"):
        emit(dict(phase="profile", card=smi, path=f"strategy_{name}",
                  **profile_chunk(torch, runs[name], median[name])))
    runs["mifa epoch"] = chunk_setup(torch, train, engine, federated,
                                     with_flags(MAIN_FLAGS, strategy="mifa",
                                                sampling="epoch"))
    for r in runs.values():
        torch.cuda.set_sync_debug_mode("error")
        r["state"], r["ss"], _ = r["chunk"](r["state"], r["ss"], r["store"],
                                            r["key"])
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit(dict(phase="strategy_sync_free", card=smi, chunks=list(runs)))
    del runs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3g: the seed-batched executor and the grid, K1 and K2's seed axis
# ---------------------------------------------------------------------------

#: the FL path's task (m, s, batch, samples) and the Table-6 CNN
SEED_TASK = dict(m=M_MAIN, s=5, batch=32, n_samples=20000)
N_SEEDS = 4
#: rounds of each seed path, one chunk of 16 (32 before phase 3n, cut so
#: that the whole script stays near 1 000 s)
SEED_ROUNDS = 16
#: K1 with a seed axis, (S, m, N): the main path's stacks for 4 seeds, and
#: a shape of 2 slices and rows off 16 bytes
SEED_CASES = [(N_SEEDS, M_MAIN, N_MAIN), (3, 1024, 4099)]


def seed_inputs(torch, S, m, n, dtype, seed, upload, empty_seed=None):
    """``make_inputs`` for S seeds stacked: x, y [S, m, n], g [S, n], mask,
    echo, upload [S, m]; seed ``empty_seed``'s mask all zero."""
    parts = [make_inputs(torch, m, n, dtype, seed=seed + j, upload=upload)
             for j in range(S)]
    a = {k: None if parts[0][k] is None
         else torch.stack([p[k] for p in parts]) for k in parts[0]}
    if empty_seed is not None:
        a["mask"][empty_seed] = 0.0
    return a


def check_seed_axis(torch, ops, ref):
    """K1 over a seed axis (``ops._echo_aggregate_cuda`` on [S, m, N]
    stacks, one launch): at each of SEED_CASES, in float32 and bfloat16,
    guarded (K1), with upload weights (K2) and without the guard (K3),
    each seed's output bit-equal to a launch on that seed alone at the
    same slice count and to ``echo_aggregate_split_ref``, and within the
    plain version's tolerance; with the guard, seed 1's mask all zero
    returns seed 1's global exactly while the others aggregate."""
    out = []
    for i, (S, m, n) in enumerate(SEED_CASES):
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            for variant in ("K1", "K2", "K3"):
                guard = variant != "K3"
                a = seed_inputs(torch, S, m, n, dtype, 300 + 10 * i,
                                upload=variant == "K2",
                                empty_seed=1 if guard else None)
                g = a["g"] if guard else None
                slices = ops.launch_geometry(m, n, a["x"].element_size(),
                                             n_sm(torch), S)[1]
                got = ops._echo_aggregate_cuda(
                    a["x"], a["y"], g, a["mask"], a["echo"], ETA_G,
                    upload=a["upload"], slices=slices)
                singles = torch.stack([ops._echo_aggregate_cuda(
                    a["x"][j], a["y"][j], None if g is None else g[j],
                    a["mask"][j], a["echo"][j], ETA_G,
                    upload=None if a["upload"] is None else a["upload"][j],
                    slices=slices) for j in range(S)])
                split = ref.echo_aggregate_split_ref(
                    a["x"], a["y"], g, a["mask"], a["echo"], ETA_G,
                    slices=slices, upload=a["upload"])
                plain = (ref.echo_aggregate_fused_ref(
                    a["x"], a["y"], g, a["mask"], a["echo"], ETA_G,
                    upload=a["upload"]) if guard else ref.echo_aggregate_ref(
                    a["x"], a["y"], a["mask"], a["echo"], ETA_G))
                torch.cuda.synchronize()
                tol = 1e-5 if dtype == torch.float32 else 5e-2
                err = (got - plain).abs().max().item()
                ok = (got.shape == (S, n) and bool(torch.isfinite(got).all())
                      and torch.equal(got, singles)
                      and torch.equal(got, split)
                      and torch.allclose(got, plain, rtol=tol, atol=tol)
                      and (not guard or (torch.equal(got[1], g[1])
                                         and not torch.equal(got[0], g[0]))))
                emit(dict(phase="seed_kernel_check", kernel=variant,
                          seeds=S, m=m, n=n, dtype=dname, slices=slices,
                          empty_seed=1 if guard else None,
                          bit_equal_single_launches=torch.equal(got,
                                                                singles),
                          bit_equal_split_ref=torch.equal(got, split),
                          max_abs_err=err, tol=tol, ok=ok))
                require(ok, f"{variant} with a seed axis at ({S}, {m}, {n}, "
                        f"{dname}) disagrees")
                out.append(err)
                del a, got, singles, split, plain
    torch.cuda.empty_cache()
    return max(out)


def seed_cell(torch, experiments, name, use_kernel=True):
    """The cell ``name``'s task at SEED_TASK on the card."""
    return experiments._cell_task(
        experiments.get_scenario(name), preset="image", seed=0,
        use_kernel=use_kernel, rounds=SEED_ROUNDS,
        device=torch.device("cuda"), **SEED_TASK)


def seeds_main_path(torch, experiments, engine, federated, prng, counts,
                    smi):
    """``run_scenario("fedawe/sine")`` for N_SEEDS seeds and SEED_ROUNDS
    rounds, K = 16, with the kernel, every count at 0 just before: K1 once
    a round for all seeds, every loss finite.  Then the same seeds through
    the executor against N_SEEDS single-seed runs driven by fold_in(rng,
    j) / fold_in(data_key, j): n_active histories, τ, key and sampler
    carry bit-equal, globals within 1e-4; one more seed chunk under
    ``set_sync_debug_mode("error")``."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        # torch.func.vmap's slow path (a loop over the seeds for an op
        # without a batching rule) warns; here it fails the run
        warnings.filterwarnings("error", message=".*performance drop")
        rec = experiments.run_scenario(
            experiments.get_scenario("fedawe/sine"), seeds=N_SEEDS,
            rounds=SEED_ROUNDS, chunk_rounds=16, use_kernel=True,
            device="cuda", **SEED_TASK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    peak = torch.cuda.max_memory_allocated()
    require(launches == dict(K1=SEED_ROUNDS, K2=0, K3=0, K4=0, K5=0),
            f"seeds path launches {launches}")
    hists = rec["histories"]
    require(len(hists) == N_SEEDS and all(
        len(h) == SEED_ROUNDS and all(math.isfinite(r["loss"]) for r in h)
        for h in hists), "seeds path: histories or losses")

    dev = torch.device("cuda")
    fl, rf, params, ds, _, _, _, _ = seed_cell(torch, experiments,
                                               "fedawe/sine")
    store = ds.device_store(dev)
    init, sample = federated.make_device_sampler(
        fl.m, fl.s, SEED_TASK["batch"],
        min_count=min(len(ix) for ix in ds.client_indices))
    rng, dk = prng.PRNGKey(0, dev), prng.PRNGKey(1, dev)
    states, sss, dks = experiments.build_seed_batch(
        fl, params, rng, dk, init, store, N_SEEDS)
    chunk = engine.make_seeds_chunk_fn(fl, rf, sample, 16, N_SEEDS)
    got = {}

    def grab(st, done, ss):
        got["ss"] = ss

    # the parity runs are timed too (CUDA events around each run, its
    # metric fetches included): ms per round beside phase 4's turns
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    states, seed_hists = experiments.run_seed_rounds(
        states, chunk, SEED_ROUNDS, 16, sampler_states=sss, store=store,
        data_keys=dks, n_seeds=N_SEEDS, ckpt_fn=grab,
        ckpt_every=SEED_ROUNDS)
    end.record()
    end.synchronize()
    run_ms = {"seeds": start.elapsed_time(end) / SEED_ROUNDS, "single": []}
    diffs = []
    for j in range(N_SEEDS):
        dkj = prng.fold_in(dk, j)
        single = {}

        def grab_single(st, done, ss):
            single["ss"] = ss

        st0 = engine.init_fl_state(prng.fold_in(rng, j), fl, params)
        ss0 = init(store, dkj)
        start.record()
        st, h = engine.run_rounds(
            st0, rf, None, SEED_ROUNDS, chunk_rounds=16, sample_fn=sample,
            store=store, data_key=dkj, sampler_state=ss0,
            ckpt_fn=grab_single, ckpt_every=SEED_ROUNDS)
        end.record()
        end.synchronize()
        run_ms["single"].append(start.elapsed_time(end) / SEED_ROUNDS)
        sj = engine.index_seed(states, j)
        series = [r["n_active"] for r in h]
        require(series == [r["n_active"] for r in seed_hists[j]]
                == [r["n_active"] for r in hists[j]],
                f"seed {j}: n_active differs from its single-seed run")
        for k in ("tau", "rng", "t", "markov"):
            require(torch.equal(getattr(st, k), getattr(sj, k)),
                    f"seed {j}: {k} differs from its single-seed run")
        carry = engine.index_seed(got["ss"], j)
        require(set(carry) == set(single["ss"]) and all(
            torch.equal(carry[k], single["ss"][k]) for k in carry),
            f"seed {j}: sampler carry differs")
        diffs.append((st.global_tr - sj.global_tr).abs().max().item())
        require(diffs[-1] <= 1e-4, f"seed {j}: globals differ by "
                f"{diffs[-1]}")
    require(len({tuple(r["n_active"] for r in h) for h in hists})
            == N_SEEDS, "the seeds drew the same availability")
    torch.cuda.set_sync_debug_mode("error")
    chunk(states, got["ss"], store, dks)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit(dict(phase="seeds_main_path", card=smi, scenario="fedawe/sine",
              seeds=N_SEEDS, rounds=SEED_ROUNDS, chunk_rounds=16,
              m=M_MAIN, n=N_MAIN, launches=launches, wall_s=wall,
              peak_above_start_mb=(peak - before) / 1e6,
              last_loss=[h[-1]["loss"] for h in hists],
              sum_n_active=[sum(r["n_active"] for r in h) for h in hists],
              final_eval_acc=rec["final"]["eval_acc"],
              single_seed_global_diff=diffs, sync_free_chunk=True,
              run_ms_per_round=run_ms))
    return launches


def seeds_fault_path(torch, experiments, prng, staleness, counts, smi):
    """``fedawe/stale_d2+midround`` for N_SEEDS seeds through
    ``run_multi_seed`` with the kernel: K2 once a round for all seeds and
    nothing else, every loss finite, and seed by seed sum(n_active) ==
    sum(n_stale) + the updates still pending in its ring."""
    fl, rf, params, ds, _, _, fault, stale = seed_cell(
        torch, experiments, "fedawe/stale_d2+midround")
    dev = torch.device("cuda")
    counts.reset()
    states, hists, _ = experiments.run_multi_seed(
        fl, rf, params, ds, sampling="uniform", batch=SEED_TASK["batch"],
        seeds=N_SEEDS, rounds=SEED_ROUNDS, chunk_rounds=16,
        rng=prng.PRNGKey(0, dev), data_key=prng.PRNGKey(1, dev),
        fault=fault, stale=stale)
    torch.cuda.synchronize()
    launches = counts.read()
    require(launches == dict(K1=0, K2=SEED_ROUNDS, K3=0, K4=0, K5=0),
            f"seeds fault path launches {launches}")
    sums = []
    for j, h in enumerate(hists):
        pending = staleness.pending_count(
            {"ages": states.stale["ages"][j]}).item()
        sj = {k: sum(r[k] for r in h)
              for k in ("n_active", "n_stale", "n_dropped")}
        require(all(math.isfinite(r["loss"]) for r in h),
                f"seed {j}: loss not finite")
        require(sj["n_active"] == sj["n_stale"] + pending,
                f"seed {j}: sum(n_active) != sum(n_stale) + pending")
        require(sj["n_dropped"] > 0 and sj["n_stale"] > 0,
                f"seed {j}: nothing dropped or delivered late")
        sums.append(dict(sj, pending=pending))
    emit(dict(phase="seeds_fault_path", card=smi,
              scenario="fedawe/stale_d2+midround", seeds=N_SEEDS,
              rounds=SEED_ROUNDS, launches=launches, per_seed=sums))
    return launches


def packed_grid_path(torch, experiments, counts, smi):
    """``run_packed_grid`` over the speedup-sine grid (7 cells), N_SEEDS
    seeds, 16 rounds, with the kernel: K1 once a round in the fedawe and
    fedawe_m cells and in no other (each cell's own run counted), every
    cell's histories equal to its unpacked ``run_scenario`` (counts and
    echoes to the bit; losses within 1e-4: cuDNN's convolution backward
    need not give the same bits twice)."""
    names = experiments.GRIDS["speedup-sine"]
    kw = dict(seeds=N_SEEDS, rounds=16, chunk_rounds=16, use_kernel=True,
              device="cuda", **SEED_TASK)
    counts.reset()
    t0 = time.perf_counter()
    packed = experiments.run_packed_grid(names, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    stateful = [n for n in names
                if n.split("/")[0] in ("fedawe", "fedawe_m")]
    require(launches == dict(K1=16 * len(stateful), K2=0, K3=0, K4=0, K5=0),
            f"packed grid launches {launches}")
    loss_diff = 0.0
    per_cell = {}
    for name, rp in zip(names, packed):
        counts.reset()
        ru = experiments.run_scenario(experiments.get_scenario(name), **kw)
        torch.cuda.synchronize()
        per_cell[name] = counts.read()["K1"]
        require(per_cell[name] == (16 if name in stateful else 0),
                f"{name}: K1 launched {per_cell[name]} times")
        for hp, hu in zip(rp["histories"], ru["histories"]):
            require(len(hp) == len(hu) == 16, f"{name}: history lengths")
            for a, b in zip(hp, hu):
                require(set(a) == set(b), f"{name}: metric keys")
                for k in a:
                    if k == "loss":
                        loss_diff = max(loss_diff, abs(a[k] - b[k]))
                    else:
                        require(a[k] == b[k], f"{name}: {k} differs")
    require(loss_diff <= 1e-4, f"packed vs unpacked losses differ by "
            f"{loss_diff}")
    emit(dict(phase="packed_grid", card=smi, grid="speedup-sine",
              cells=len(names), seeds=N_SEEDS, rounds=16, wall_s=wall,
              launches=launches, k1_per_cell=per_cell,
              packed_vs_unpacked_loss=loss_diff))


def time_seeds(torch, train, engine, experiments, federated, ops, smi):
    """ms per round of the 4-seed chunk and of the single-seed chunk of
    the main path's flags with the kernel, built from one setup (CUDA
    events, one 16-round chunk per turn: single, seeds, seeds, single),
    seed-rounds per second, peak allocated memory over one chunk of
    each, a profiler breakdown of a 4-round 4-seed chunk; then the
    batched K1 at [4, 100, 27 370] float32 against four single launches
    (CUDA graphs over 8 rotating operand sets) and against its HBM
    bound."""
    t0 = time.perf_counter()
    args = train.build_parser().parse_args(MAIN_FLAGS + ["--use-kernel"])
    dev = torch.device("cuda")
    parts = train.setup(args, dev)
    store = parts["ds"].device_store(dev)
    init, sample = federated.make_device_sampler(args.m, args.s, args.batch)
    key = parts["data_key"]
    K = args.chunk_rounds
    single = dict(state=parts["state"], ss=init(store, key), store=store,
                  key=key, args=args, chunk=engine.make_chunk_fn(
                      None, parts["round_fn"], sample, K))
    states, sss, dks = experiments.build_seed_batch(
        parts["fl"], parts["params"], parts["rng"], key, init, store,
        N_SEEDS)
    seeds = dict(single, state=states, ss=sss, key=dks,
                 chunk=engine.make_seeds_chunk_fn(
                     parts["fl"], parts["round_fn"], sample, K, N_SEEDS))
    peaks = {}
    for name, r in (("single", single), ("seeds", seeds)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        chunks_ms(torch, r, 1)
        peaks[name] = (torch.cuda.max_memory_allocated() - before) / 1e6
    turns = {"single": [], "seeds": []}
    for name in ("single", "seeds", "seeds", "single"):
        turns[name].append(chunks_ms(torch, single if name == "single"
                                     else seeds, 1))
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    t1 = time.perf_counter()
    # the profiler's event list grows with the launches: 4 rounds
    short = dict(seeds, args=types.SimpleNamespace(chunk_rounds=4),
                 chunk=engine.make_seeds_chunk_fn(
                     parts["fl"], parts["round_fn"], sample, 4, N_SEEDS))
    prof = profile_chunk(torch, short, ms["seeds"])
    t2 = time.perf_counter()
    emit(dict(phase="seeds_round_time", card=smi, seeds=N_SEEDS,
              chunk_rounds=K, round_ms_turns=turns, round_ms=ms,
              seed_rounds_per_s={"single": 1e3 / ms["single"],
                                 "seeds": N_SEEDS * 1e3 / ms["seeds"]},
              speedup=N_SEEDS * ms["single"] / ms["seeds"],
              peak_above_start_mb_one_chunk=peaks, seconds=t1 - t0))
    emit(dict(phase="profile", card=smi, path=f"seeds_{N_SEEDS}",
              seconds=t2 - t1, **prof))
    del single, seeds, short, states, sss, parts
    torch.cuda.empty_cache()

    sets = [seed_inputs(torch, N_SEEDS, M_MAIN, N_MAIN, torch.float32,
                        seed=600 + 10 * i, upload=False) for i in range(8)]

    def batched(i):
        a = sets[i % 8]
        return ops.echo_aggregate_flat(a["x"], a["y"], a["g"], a["mask"],
                                       a["echo"], ETA_G)

    def four(i):
        a = sets[i % 8]
        return [ops.echo_aggregate_flat(a["x"][j], a["y"][j], a["g"][j],
                                        a["mask"][j], a["echo"][j], ETA_G)
                for j in range(N_SEEDS)]

    t = [graph_ms(torch, f, 32) for f in (batched, four, four, batched)]
    b_ms, b_by, nbytes = bound(M_MAIN, N_MAIN, 4, True, seeds=N_SEEDS)
    rec = dict(ms=(t[0] + t[3]) / 2, turns_ms=[t[0], t[3]],
               four_launches_ms=(t[1] + t[2]) / 2,
               four_turns_ms=[t[1], t[2]], bound_ms=b_ms, bound_by=b_by,
               bytes=nbytes, seconds=time.perf_counter() - t2)
    rec["share"] = b_ms / rec["ms"]
    emit(dict(phase="seed_kernel_time", card=smi, kernel="K1",
              seeds=N_SEEDS, m=M_MAIN, n=N_MAIN, **rec))
    del sets
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 3h: the sparse cohort round, K1 on its [c, N] working set
# ---------------------------------------------------------------------------

#: the scale tier (tests/test_sparse_cohort.py:342,
#: benchmarks/kernels_bench.py:405-495): m = 10^5 clients owning 8
#: contiguous samples each, sine availability around p = 0.002 (about 200
#: actives a round), a cohort of at most 256 over a bfloat16 [m, N] stack
COHORT_M, COHORT_N_PER, COHORT_P = 100_000, 8, 0.002
COHORT_K, COHORT_ROUNDS, COHORT_MIFA_ROUNDS = 8, 32, 8
#: phase 3h's m = 100 runs: 24 rounds in chunks of 16 (a T % K tail)
COHORT_SMALL = dict(rounds=24)


def cohort_store(torch, federated):
    """The m = 10^5 store: 800 000 synthetic 8x8x1 images (seed 0), client
    i owning rows [8 i, 8 i + 8) (``contiguous_client_index``; the image
    preset's Dirichlet split cannot give 10^5 clients a sample each)."""
    from repro_torch.data import make_image_classification

    task = make_image_classification(seed=0, n=COHORT_M * COHORT_N_PER,
                                     shape=(8, 8, 1))
    # TF32 stays off: the engine applies the float32 policy where it
    # builds this path's state and round
    return federated.device_store(
        dict(images=task.images, labels=task.labels), None,
        torch.device("cuda"),
        padded=federated.contiguous_client_index(COHORT_M, COHORT_N_PER))


def cohort_scale_setup(torch, engine, federated, cnn, prng, availability,
                       store, strategy, use_kernel):
    """The m = 10^5 cohort run on ``store``, built from the engine's entry
    points: the chunk executor of COHORT_K rounds, the state, the sampler
    carry and the initial global."""
    dev = torch.device("cuda")
    cfg = engine.FLConfig(m=COHORT_M, s=5, strategy=strategy,
                          use_kernel=use_kernel, flat_state=True,
                          sparse_cohort=COHORT_C, resident_dtype="bfloat16")
    params = cnn.init_cnn(prng.PRNGKey(0, dev), in_shape=(8, 8, 1),
                          n_classes=10)
    rf = engine.make_round_fn(
        cfg, cnn.make_image_loss_fn(cnn.cnn_apply), {},
        availability.AvailabilityCfg(kind="sine", gamma=0.3),
        torch.full((COHORT_M,), COHORT_P, device=dev))
    init, sample = federated.make_device_sampler(
        COHORT_M, 5, 32, min_count=COHORT_N_PER, emit="cols")
    key = prng.PRNGKey(1, dev)
    state = engine.init_fl_state(prng.PRNGKey(0, dev), cfg, params)
    return dict(cfg=cfg, rf=rf, sample=sample, store=store, key=key,
                state=state, ss=init(store, key),
                g0=state.global_tr.clone(),
                chunk=engine.make_chunk_fn(cfg, rf, sample, COHORT_K))


def cohort_chunks(torch, engine, r, n_chunks):
    """``n_chunks`` chunks of the run ``r`` (carried on): per chunk the ms
    per round between CUDA events and the peak allocated memory above
    what was allocated before it; the metrics of every round."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms, peaks, hist = [], [], []
    for _ in range(n_chunks):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start.record()
        r["state"], r["ss"], metrics = r["chunk"](r["state"], r["ss"],
                                                  r["store"], r["key"])
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / COHORT_K)
        peaks.append(torch.cuda.max_memory_allocated() - before)
        vals = engine._metrics_to_host(metrics)
        hist += [{k: v[j] for k, v in vals.items()} for j in range(COHORT_K)]
    return ms, peaks, hist


def rows_unchanged(torch, stack, tau, g0, step=8192):
    """Do the rows of clients that never computed (τ < 0) still hold the
    initial global in the stack's dtype, bit for bit?  (Row blocks, so no
    [m, N] temporary.)"""
    want = g0.to(stack.dtype)
    for lo in range(0, stack.shape[0], step):
        idle = tau[lo:lo + step] < 0
        if not bool(torch.equal(stack[lo:lo + step][idle],
                                want.expand(int(idle.sum()), -1))):
            return False
    return True


def all_finite(torch, stack, step=8192):
    return all(bool(torch.isfinite(stack[lo:lo + step]).all())
               for lo in range(0, stack.shape[0], step))


def cohort_scale_path(torch, engine, federated, cnn, prng, availability,
                      ops, ref, counts, smi):
    """FedAWE with the kernel at m = 10^5 for COHORT_ROUNDS rounds, every
    count at 0 just before: K1 once a round on the [256, 27 370] working
    set, every loss finite, the rows of clients that never computed
    bit-unchanged, and each chunk's peak allocated memory above the
    resident state under one bfloat16 [m, N] stack.  The same run without
    the kernel: n_active and n_deferred bit-equal, τ equal, the global
    within 1e-4.  MIFA for COHORT_MIFA_ROUNDS rounds (a second bfloat16
    [m, N] stack, its memory).  Then one profiled 4-round chunk and K1
    alone at [256, 27 370] float32 against its bound."""
    t0 = time.perf_counter()
    stack_bytes = COHORT_M * N_MAIN * 2
    store = cohort_store(torch, federated)
    runs = {}
    for use_kernel in (True, False):
        r = cohort_scale_setup(torch, engine, federated, cnn, prng,
                               availability, store, "fedawe", use_kernel)
        counts.reset()
        ms, peaks, hist = cohort_chunks(torch, engine, r,
                                        COHORT_ROUNDS // COHORT_K)
        launches = counts.read()
        st = r["state"]
        require(st.clients_tr.dtype == torch.bfloat16
                and st.clients_tr.shape == (COHORT_M, N_MAIN),
                "the resident stack is not bf16 [m, N]")
        require(all(math.isfinite(h["loss"]) for h in hist),
                f"cohort losses {[h['loss'] for h in hist]}")
        require(max(peaks) < stack_bytes, f"peak above the resident state "
                f"{max(peaks)} B: not below one bf16 [m, N] stack")
        runs[use_kernel] = dict(
            ms=ms, peaks=peaks, hist=hist, launches=launches,
            tau=st.tau.clone(), g=st.global_tr.clone(),
            unchanged=rows_unchanged(torch, st.clients_tr, st.tau,
                                     r["g0"]))
        require(runs[use_kernel]["unchanged"],
                "rows of clients that never computed changed")
        if use_kernel:
            # one profiled 4-round chunk, after the checked rounds
            r["chunk"] = engine.make_chunk_fn(r["cfg"], r["rf"], r["sample"],
                                              4)
            r["args"] = types.SimpleNamespace(chunk_rounds=4)
            prof = profile_chunk(torch, r, sum(ms[1:]) / len(ms[1:]))
        del r, st
        torch.cuda.empty_cache()
    k, p = runs[True], runs[False]
    require(k["launches"] == dict(K1=COHORT_ROUNDS, K2=0, K3=0, K4=0, K5=0),
            f"cohort path launches {k['launches']}")
    require(p["launches"]["K1"] == 0, "the plain cohort run launched K1")
    for key in ("n_active", "n_deferred"):
        require([h[key] for h in k["hist"]] == [h[key] for h in p["hist"]],
                f"kernel vs plain {key} differ")
    require(torch.equal(k["tau"], p["tau"]), "kernel vs plain tau differ")
    diff = (k["g"] - p["g"]).abs().max().item()
    require(diff <= 1e-4, f"kernel vs plain cohort global differ by {diff}")
    n_act = [h["n_active"] for h in k["hist"]]
    n_def = [h["n_deferred"] for h in k["hist"]]
    require(all(a <= COHORT_C for a in n_act) and sum(n_act) > 0,
            f"n_active {n_act}")
    computed = int((k["tau"] >= 0).sum())
    t1 = time.perf_counter()

    r = cohort_scale_setup(torch, engine, federated, cnn, prng,
                           availability, store, "mifa", True)
    counts.reset()
    mifa_ms, mifa_peaks, mifa_hist = cohort_chunks(
        torch, engine, r, COHORT_MIFA_ROUNDS // COHORT_K)
    mifa_launches = counts.read()
    st = r["state"]
    require(mifa_launches == dict(K1=0, K2=0, K3=0, K4=0, K5=0),
            f"mifa cohort launches {mifa_launches}")
    require(st.clients_tr is None and st.extra["mem"].dtype == torch.bfloat16
            and st.extra["mem"].shape == (COHORT_M, N_MAIN),
            "mifa's memory is not a bf16 [m, N] stack")
    require(all(math.isfinite(h["loss"]) for h in mifa_hist)
            and all_finite(torch, st.extra["mem"])
            and bool(torch.isfinite(st.extra["mem_sum"]).all())
            and bool(torch.isfinite(st.global_tr).all()),
            "mifa cohort run not finite")
    require(max(mifa_peaks) < stack_bytes,
            f"mifa peak above the resident state {max(mifa_peaks)} B")
    del r, st, store
    torch.cuda.empty_cache()
    t2 = time.perf_counter()

    # K1 alone at the path's shape: 8 rotating float32 operand sets
    # (8 x 56 MB, none still in the 50 MB L2 when it comes round again)
    sets = [make_inputs(torch, COHORT_C, N_MAIN, torch.float32,
                        seed=700 + i, mask_p=0.8) for i in range(8)]
    t = [graph_ms(torch, lambda i: call_kernel(ops, "K1", sets[i % 8]), 32)
         for _ in range(2)]
    plain = graph_ms(torch, lambda i: call_plain(ref, "K1", sets[i % 8]), 32)
    b_ms, b_by, nbytes = bound(COHORT_C, N_MAIN, 4, True)
    kernel_rec = dict(ms=sum(t) / 2, turns_ms=t, plain_ms=plain,
                      bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                      share=b_ms / (sum(t) / 2))
    del sets
    torch.cuda.empty_cache()
    steady = k["ms"][1:]
    emit(dict(phase="cohort_scale_path", card=smi, m=COHORT_M, c=COHORT_C,
              n=N_MAIN, resident="bfloat16", rounds=COHORT_ROUNDS,
              chunk_rounds=COHORT_K, launches=k["launches"],
              ms_per_round_by_chunk={"kernel": k["ms"], "plain": p["ms"]},
              round_ms=sum(steady) / len(steady),
              peak_above_resident_mb={"kernel": [b / 1e6 for b in k["peaks"]],
                                      "plain": [b / 1e6 for b in p["peaks"]]},
              stack_mb=stack_bytes / 1e6, n_active=n_act, n_deferred=n_def,
              clients_computed=computed, kernel_vs_plain_global=diff,
              idle_rows_unchanged=True, seconds=t1 - t0))
    emit(dict(phase="profile", card=smi, path="cohort_scale", **prof))
    emit(dict(phase="cohort_scale_mifa", card=smi, m=COHORT_M, c=COHORT_C,
              rounds=COHORT_MIFA_ROUNDS, launches=mifa_launches,
              ms_per_round_by_chunk=mifa_ms,
              peak_above_resident_mb=[b / 1e6 for b in mifa_peaks],
              last_loss=mifa_hist[-1]["loss"], seconds=t2 - t1))
    emit(dict(phase="kernel_time", card=smi, kernel="K1", path="cohort",
              m=COHORT_C, n=N_MAIN, **kernel_rec))
    return k["launches"], kernel_rec


def cohort_dense_path(torch, train, counts, smi):
    """At m = 100 through ``train.run``: ``--sparse-cohort 100`` (c = m)
    in float32 against the dense run, with the kernel, under the main
    path's flags and under FAULT_FLAGS (faults and staleness through the
    chunked executor with a T % K tail): counts, τ and keys bit-equal,
    n_deferred 0, globals within 1e-4.  bfloat16 residency within the
    reference's 2e-2 of the float32 cohort run."""
    parser = train.build_parser()
    out = {}
    for name, flags in (("sync", MAIN_FLAGS), ("faults_stale", FAULT_FLAGS)):
        base = with_flags(flags, **COHORT_SMALL) + ["--use-kernel"]
        res = {}
        for kind, extra in (("dense", []),
                            ("cohort", ["--sparse-cohort", str(M_MAIN)]),
                            ("cohort_bf16", ["--sparse-cohort", str(M_MAIN),
                                             "--resident-dtype",
                                             "bfloat16"])):
            if name == "faults_stale" and kind == "cohort_bf16":
                continue
            counts.reset()
            state, hist, _ = train.run(parser.parse_args(base + extra))
            res[kind] = (state, hist, counts.read())
        (sd, hd, ld), (sc, hc, lc) = res["dense"], res["cohort"]
        keys = [k for k in hd[0] if k.startswith("n_")]
        require(len(hd) == len(hc) == COHORT_SMALL["rounds"],
                f"{name}: round counts")
        for hist in [hc] + ([res["cohort_bf16"][1]]
                            if "cohort_bf16" in res else []):
            require(all(h["n_deferred"] == 0.0 for h in hist),
                    f"{name}: deferrals at c = m")
            for key in keys:
                require([h[key] for h in hist] == [h[key] for h in hd],
                        f"{name}: {key} differs between cohort and dense")
        for key in ("tau", "t", "rng", "markov"):
            require(torch.equal(getattr(sc, key), getattr(sd, key)),
                    f"{name}: {key} differs between cohort and dense")
        require(ld == lc, f"{name}: launches {ld} dense, {lc} cohort")
        diff = (sc.global_tr - sd.global_tr).abs().max().item()
        require(diff <= 1e-4, f"{name}: cohort vs dense global {diff}")
        rec = dict(launches=lc, cohort_vs_dense_global=diff,
                   sum_n_active=sum(h["n_active"] for h in hc))
        if "cohort_bf16" in res:
            sb = res["cohort_bf16"][0]
            require(sb.clients_tr.dtype == torch.bfloat16,
                    "bf16 run's stack is not bf16")
            bdiff = (sb.global_tr - sc.global_tr).abs().max().item()
            require(bdiff <= 2e-2, f"bf16 vs f32 cohort global {bdiff}")
            rec["bf16_vs_f32_global"] = bdiff
        out[name] = rec
        del res
    emit(dict(phase="cohort_dense_path", card=smi, m=M_MAIN, c=M_MAIN,
              **COHORT_SMALL, **out))
    return out


def cohort_seeds_path(torch, train, engine, experiments, federated, prng,
                      counts, smi):
    """``train --seeds 4 --sparse-cohort 32`` at m = 100 with the kernel:
    K1 once a round for all seeds (on [4, 32, 27 370]), every loss finite.
    Then the same seeds through the executor against four single-seed
    cohort runs driven by fold_in(rng, j) / fold_in(data_key, j): n_active
    and n_deferred histories, τ, key, markov state and sampler carry
    bit-equal, globals within 1e-4."""
    flags = with_flags(MAIN_FLAGS, rounds=SEED_ROUNDS) + [
        "--use-kernel", "--sparse-cohort", "32"]
    args = train.build_parser().parse_args(flags + ["--seeds",
                                                    str(N_SEEDS)])
    counts.reset()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop")
        states, hists, _ = train.run(args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.read()
    require(launches == dict(K1=SEED_ROUNDS, K2=0, K3=0, K4=0, K5=0),
            f"cohort seeds launches {launches}")
    require(all(len(h) == SEED_ROUNDS and all(
        math.isfinite(r["loss"]) for r in h) for h in hists),
        "cohort seeds: histories or losses")

    dev = torch.device("cuda")
    parts = train.setup(args, dev)
    fl, rf, params = parts["fl"], parts["round_fn"], parts["params"]
    store = parts["ds"].device_store(dev)
    init, sample = federated.make_device_sampler(
        fl.m, fl.s, args.batch, emit="cols",
        min_count=min(len(ix) for ix in parts["ds"].client_indices))
    rng, dk = parts["rng"], parts["data_key"]
    states, sss, dks = experiments.build_seed_batch(fl, params, rng, dk,
                                                    init, store, N_SEEDS)
    got, K = {}, args.chunk_rounds
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop")
        states, seed_hists = experiments.run_seed_rounds(
            states, engine.make_seeds_chunk_fn(fl, rf, sample, K, N_SEEDS),
            SEED_ROUNDS, K, sampler_states=sss, store=store, data_keys=dks,
            n_seeds=N_SEEDS,
            ckpt_fn=lambda st, done, ss: got.update(ss=ss),
            ckpt_every=SEED_ROUNDS)
    diffs = []
    for j in range(N_SEEDS):
        single = {}
        st, h = engine.run_rounds(
            engine.init_fl_state(prng.fold_in(rng, j), fl, params), rf,
            None, SEED_ROUNDS, chunk_rounds=K, sample_fn=sample,
            store=store, data_key=prng.fold_in(dk, j),
            sampler_state=init(store, prng.fold_in(dk, j)),
            ckpt_fn=lambda s_, done, ss: single.update(ss=ss),
            ckpt_every=SEED_ROUNDS)
        sj = engine.index_seed(states, j)
        for key in ("n_active", "n_deferred"):
            require([r[key] for r in h] == [r[key] for r in seed_hists[j]]
                    == [r[key] for r in hists[j]],
                    f"cohort seed {j}: {key} differs from its single run")
        for key in ("tau", "rng", "t", "markov"):
            require(torch.equal(getattr(st, key), getattr(sj, key)),
                    f"cohort seed {j}: {key} differs from its single run")
        carry = engine.index_seed(got["ss"], j)
        require(set(carry) == set(single["ss"]) and all(
            torch.equal(carry[k], single["ss"][k]) for k in carry),
            f"cohort seed {j}: sampler carry differs")
        diffs.append((st.global_tr - sj.global_tr).abs().max().item())
        require(diffs[-1] <= 1e-4,
                f"cohort seed {j}: globals differ by {diffs[-1]}")
    emit(dict(phase="cohort_seeds_path", card=smi, seeds=N_SEEDS, m=M_MAIN,
              c=32, rounds=SEED_ROUNDS, launches=launches, wall_s=wall,
              sum_n_deferred=[sum(r["n_deferred"] for r in h)
                              for h in hists],
              single_seed_global_diff=diffs))
    return launches


# ---------------------------------------------------------------------------
# phase 3i: the tree-state round, K1 and K2 through their tree route
# ---------------------------------------------------------------------------

#: the main path's flags on tree state, the JAX package's default
#: substrate: MAIN_FLAGS without --flat-state
TREE_FLAGS = [f for f in MAIN_FLAGS if f != "--flat-state"]
#: the tree round's fault path: mid-round dropout with sanitization (K2)
TREE_FAULT = ["--midround-drop", "0.3", "--sanitize"]
TREE_ROUNDS, TREE_STRAT_ROUNDS = 64, 16
#: the paper harness's "linear" model (benchmarks/common.py:31-56, run_fl
#: :64-80): Gaussian 8x8 classes at margin 0.3, Dirichlet(0.05) over m =
#: 32 clients, s = 4, batch 16; N = 650
LINEAR_M, LINEAR_ROUNDS = 32, 32
LINEAR_N = 650


@contextlib.contextmanager
def launch_shapes(ops):
    """The shapes of the stacks K1-K3 are launched on inside the block
    (``ops._launch`` wrapped; the wrappers count their launches as
    always)."""
    shapes = []
    launch = ops._launch

    def recording(x, *args, **kw):
        shapes.append(tuple(x.shape))
        return launch(x, *args, **kw)

    ops._launch = recording
    try:
        yield shapes
    finally:
        ops._launch = launch


def only(**kv):
    """A launch-count dict with every kernel at 0 but ``kv``."""
    return dict(dict(K1=0, K2=0, K3=0, K4=0, K5=0), **kv)


def tree_leaves_finite(torch, tree):
    from repro_torch.core.tree_util import tree_leaves
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree))


def tree_route_inputs(torch, spec, seed, upload):
    """The tree FedAWE update's operands at the main path's shapes: the
    full-width CNN's 8 leaves stacked over M_MAIN clients (start and
    post-SGD models, each leaf its own buffer), the global tree, and
    ``make_inputs``' mask and echo, and for K2 a 0/1 upload mask (the
    tree round delivers or drops; the plain tree update weighs the echo
    term by its mask too, so it equals the kernel only on 0/1 weights);
    also the raveled stacks they came from."""
    from repro_torch.core.tree_util import tree_map

    a = make_inputs(torch, M_MAIN, N_MAIN, torch.float32, seed,
                    upload=upload)
    if upload:
        a["upload"] = (a["upload"] > 0.6).float()

    def own(t):
        return tree_map(lambda v: v.contiguous(), t)

    return dict(a, spec=spec, xt=own(spec.unflatten_stacked(a["x"])),
                yt=own(spec.unflatten_stacked(a["y"])),
                gt=own(spec.unflatten(a["g"])))


def call_tree(ops, a):
    return ops.echo_aggregate_tree(a["xt"], a["yt"], a["mask"], a["echo"],
                                   ETA_G, a["gt"], upload=a["upload"])


def call_tree_plain(ref, a):
    """The tree route's plain version: the same raveling around the plain
    fused update (what ``echo_aggregate_tree`` computes on the CPU)."""
    spec = a["spec"]
    return spec.unflatten(ref.echo_aggregate_fused_ref(
        spec.flatten_stacked(a["xt"]), spec.flatten_stacked(a["yt"]),
        spec.flatten(a["gt"]), a["mask"], a["echo"], ETA_G,
        upload=a["upload"]))


def cnn_spec(cnn, prng, FlatSpec):
    return FlatSpec.from_tree(cnn.init_cnn(prng.PRNGKey(0, "cuda"),
                                           in_shape=(8, 8, 1)))


def check_tree_route(torch, ops, ref, strategies, cnn, prng, FlatSpec):
    """K1 and K2 through ``ops.echo_aggregate_tree`` on the CNN's 8 leaves
    at [100, 27 370]: two calls, one launch each and equal bits; bit-equal
    to ``echo_aggregate_flat`` on the raveled stacks (the same launch);
    within 1e-5 of the plain version (the raveling around the plain fused
    update, as K1's bound) and within 1e-4 of FedAWE's per-leaf plain tree
    update (``aggregate`` with ``use_kernel=False``: the reference's
    plain branch, its sums taken in another order, given the delivered
    weights ``mask * upload`` as the round gives them).  Returns the max
    abs error against the plain version per variant."""
    from repro_torch.core.tree_util import tree_sub

    spec = cnn_spec(cnn, prng, FlatSpec)
    require(spec.size == N_MAIN and spec.n_leaves == 8,
            f"CNN spec {spec.size}, {spec.n_leaves} leaves")
    errs = {}
    for i, variant in enumerate(("K1", "K2")):
        a = tree_route_inputs(torch, spec, 300 + i, variant == "K2")
        before = launch_count(ops, variant)
        outs = [spec.flatten(call_tree(ops, a)) for _ in range(2)]
        flat = call_kernel(ops, variant, a)
        torch.cuda.synchronize()
        launched = launch_count(ops, variant) - before
        plain = spec.flatten(call_tree_plain(ref, a))
        t = torch.full((), 12, dtype=torch.int32, device="cuda")
        per_leaf = strategies.get_strategy("fedawe").aggregate(
            global_tr=a["gt"], clients_tr=a["xt"],
            G=tree_sub(a["xt"], a["yt"]), mask=a["mask"], t=t,
            tau=(t - a["echo"]).to(torch.int32), probs=None, extra=(),
            eta_g=ETA_G, use_kernel=False, x_end=a["yt"],
            mask_upload=(None if a["upload"] is None
                         else a["mask"] * a["upload"]))[0]
        per_leaf = spec.flatten(per_leaf)
        torch.cuda.synchronize()
        err = (outs[0] - plain).abs().max().item()
        leaf_err = (outs[0] - per_leaf).abs().max().item()
        ok = (launched == 3 and torch.equal(outs[0], outs[1])
              and torch.equal(outs[0], flat)
              and torch.allclose(outs[0], plain, rtol=1e-5, atol=1e-5)
              and torch.allclose(outs[0], per_leaf, rtol=1e-4, atol=1e-4))
        emit(dict(phase="kernel_check", kernel=variant, route="tree",
                  m=M_MAIN, n=N_MAIN, leaves=spec.n_leaves, launches=launched,
                  two_launches_bit_equal=torch.equal(outs[0], outs[1]),
                  flat_wrapper_bit_equal=torch.equal(outs[0], flat),
                  max_abs_err=err, tol=1e-5, per_leaf_plain_err=leaf_err,
                  per_leaf_tol=1e-4, ok=ok))
        require(ok, f"{variant} tree route disagrees: {err}, {leaf_err}")
        errs[variant] = err
        del a, outs, flat, plain, per_leaf
    torch.cuda.empty_cache()
    return errs


def tree_main_path(torch, train, ops, counts, flat_run, smi):
    """``train.run`` with TREE_FLAGS and ``--use-kernel``, every count at 0
    just before: K1 TREE_ROUNDS times on [100, 27 370] and nothing else,
    every loss finite, the state a tree of the CNN's 8 leaves; against
    ``flat_run`` (phase 3a's flat run of the same flags): the n_active
    and mean_echo histories, τ, t and the key bit-equal, the raveled
    global within 1e-4.  Then both under TREE_FAULT: K2 TREE_ROUNDS times,
    n_dropped and n_rejected bit-equal too.  Returns the launches."""
    from repro_torch.core import FlatSpec

    parser = train.build_parser()
    out = {}
    for name, extra, variant in (("sync", [], "K1"),
                                 ("faults", TREE_FAULT, "K2")):
        counts.reset()
        t0 = time.perf_counter()
        with launch_shapes(ops) as shapes:
            st, hist, final = train.run(parser.parse_args(
                TREE_FLAGS + extra + ["--use-kernel"]))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts.read()
        require(launches == only(**{variant: TREE_ROUNDS}),
                f"tree {name} launches {launches}")
        require(set(shapes) == {(M_MAIN, N_MAIN)},
                f"tree {name} launched on {set(shapes)}")
        spec = FlatSpec.from_tree(st.global_tr)
        require(st.spec is None and spec.n_leaves == 8
                and spec.size == N_MAIN
                and tree_leaves_finite(torch, st.global_tr),
                f"tree {name}: not a finite tree of the CNN's leaves")
        require(len(hist) == TREE_ROUNDS
                and all(math.isfinite(h["loss"]) for h in hist),
                f"tree {name}: losses")
        if name == "sync":
            fst, fhist = flat_run
        else:
            fst, fhist, _ = train.run(parser.parse_args(
                MAIN_FLAGS + extra + ["--use-kernel"]))
        keys = [k for k in ("n_active", "mean_echo", "n_dropped",
                            "n_rejected") if k in hist[0]]
        for k in keys:
            require([h[k] for h in hist] == [h[k] for h in fhist],
                    f"tree {name}: {k} differs from the flat run")
        for k in ("tau", "t", "rng"):
            require(torch.equal(getattr(st, k), getattr(fst, k)),
                    f"tree {name}: {k} differs from the flat run")
        diff = (spec.flatten(st.global_tr) - fst.global_tr).abs().max() \
            .item()
        require(diff <= 1e-4, f"tree {name}: globals differ by {diff}")
        sums = {f"sum_{k}": sum(h[k] for h in hist) for k in keys
                if k != "mean_echo"}
        require(0 < sums["sum_n_active"] < TREE_ROUNDS * M_MAIN,
                f"tree {name}: n_active {sums}")
        if name == "faults":
            require(sums["sum_n_dropped"] > 0, "tree faults: none dropped")
        emit(dict(phase="tree_main_path", card=smi, path=name,
                  rounds=TREE_ROUNDS, m=M_MAIN, n=N_MAIN,
                  leaves=spec.n_leaves, launches=launches, wall_s=wall,
                  last_loss=hist[-1]["loss"], final_eval_acc=final,
                  tree_vs_flat_global=diff, **sums))
        out[variant] = launches[variant]
        del st, fst
    return out


def tree_strategies_path(torch, train, engine, federated, strategies, counts,
                         smi):
    """Each of the ten strategies on tree state for one chunk
    (TREE_STRAT_ROUNDS rounds) with ``--use-kernel``, every count at 0 just
    before each: K1 once a round for FedAWE and FedAWE-M only, every loss
    and the global finite, every strategy with a client tree, a memory
    strategy's memory a finite tree of [100, ...] leaves; then one FedAWE
    tree chunk under ``set_sync_debug_mode("error")``."""
    from repro_torch.core import FlatSpec

    parser = train.build_parser()
    n_active = None
    for name in STRATEGIES:
        counts.reset()
        st, hist, _ = train.run(parser.parse_args(with_flags(
            TREE_FLAGS, strategy=name, rounds=TREE_STRAT_ROUNDS)
            + ["--use-kernel"]))
        torch.cuda.synchronize()
        launched = counts.read()
        strat = strategies.get_strategy(name)
        k1 = TREE_STRAT_ROUNDS if strat.stateful_clients else 0
        require(launched == only(K1=k1), f"tree {name} launches {launched}")
        require(len(hist) == TREE_STRAT_ROUNDS
                and all(math.isfinite(h["loss"]) for h in hist)
                and tree_leaves_finite(torch, st.global_tr)
                and st.clients_tr is not None and st.spec is None,
                f"tree {name}: losses, global or client tree")
        series = [h["n_active"] for h in hist]
        n_active = n_active or series
        require(series == n_active, f"tree {name}: n_active differs")
        # a memory strategy's [m, ...] tree (FedAWE-M's velocity is one
        # model's tree)
        memory = [v for v in (st.extra.values()
                              if isinstance(st.extra, dict) else ())
                  if isinstance(v, dict)
                  and FlatSpec.from_tree(v).size == M_MAIN * N_MAIN]
        require(len(memory) == int(strat.memory_aided) and all(
            tree_leaves_finite(torch, v) for v in memory),
            f"tree {name}: memory")
        emit(dict(phase="tree_strategy", card=smi, strategy=name,
                  rounds=TREE_STRAT_ROUNDS, launches=launched,
                  last_loss=hist[-1]["loss"], memory_tree=bool(memory)))
        del st
    r = chunk_setup(torch, train, engine, federated,
                    TREE_FLAGS + ["--use-kernel"])
    torch.cuda.set_sync_debug_mode("error")
    r["state"], r["ss"], _ = r["chunk"](r["state"], r["ss"], r["store"],
                                        r["key"])
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    emit(dict(phase="tree_sync_free", card=smi, strategy="fedawe",
              rounds=r["args"].chunk_rounds))


def tree_seeds_path(torch, train, engine, federated, prng, ops, counts, smi):
    """``train --seeds N_SEEDS`` on tree state with the kernel for
    SEED_ROUNDS rounds, every count at 0 just before: K1 once a round for
    all seeds, on [4, 100, 27 370], no ``torch.func.vmap`` slow-path
    warning; each seed's n_active history, τ, t and key bit-equal to its
    single-seed tree run driven by fold_in(rng, j) / fold_in(data_key,
    j), its global within 1e-4."""
    from repro_torch.core import FlatSpec

    parser = train.build_parser()
    flags = with_flags(TREE_FLAGS, rounds=SEED_ROUNDS) + ["--use-kernel"]
    counts.reset()
    with launch_shapes(ops) as shapes, warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop")
        states, hists, final = train.run(parser.parse_args(
            flags + ["--seeds", str(N_SEEDS)]))
        torch.cuda.synchronize()
    launches = counts.read()
    require(launches == only(K1=SEED_ROUNDS), f"tree seeds {launches}")
    require(set(shapes) == {(N_SEEDS, M_MAIN, N_MAIN)},
            f"tree seeds launched on {set(shapes)}")
    args = parser.parse_args(flags)
    dev = torch.device("cuda")
    parts = train.setup(args, dev)
    store = parts["ds"].device_store(dev)
    init, sample = federated.make_device_sampler(
        args.m, args.s, args.batch,
        min_count=min(len(ix) for ix in parts["ds"].client_indices))
    diffs = []
    for j in range(N_SEEDS):
        dkj = prng.fold_in(parts["data_key"], j)
        st, h = engine.run_rounds(
            engine.init_fl_state(prng.fold_in(parts["rng"], j), parts["fl"],
                                 parts["params"]),
            parts["round_fn"], None, SEED_ROUNDS, chunk_rounds=16,
            sample_fn=sample, store=store, data_key=dkj,
            sampler_state=init(store, dkj))
        sj = engine.index_seed(states, j)
        require([r["n_active"] for r in h]
                == [r["n_active"] for r in hists[j]],
                f"tree seed {j}: n_active differs from its single run")
        for k in ("tau", "t", "rng"):
            require(torch.equal(getattr(st, k), getattr(sj, k)),
                    f"tree seed {j}: {k} differs from its single run")
        spec = FlatSpec.from_tree(st.global_tr)
        diffs.append((spec.flatten(st.global_tr)
                      - spec.flatten(sj.global_tr)).abs().max().item())
        require(diffs[-1] <= 1e-4, f"tree seed {j}: globals {diffs[-1]}")
    emit(dict(phase="tree_seeds_path", card=smi, seeds=N_SEEDS,
              rounds=SEED_ROUNDS, launches=launches,
              launch_shape=list(shapes[0]), single_seed_global_diff=diffs,
              sum_n_active=[sum(r["n_active"] for r in h) for h in hists],
              final_eval_acc=final["eval_acc"]))


def tree_linear_path(torch, engine, cnn, prng, availability, ops, counts,
                     smi):
    """The paper harness's "linear" model on tree state at m = LINEAR_M
    (its task, split and base probabilities as benchmarks/common.py
    builds them, its host loop over ``round_batches``), FedAWE with K1
    and without, LINEAR_ROUNDS rounds each, built from the engine: with
    both TF32 flags set first, the engine-built CUDA state leaves both
    off; K1 once a round on [32, 650]; n_active and τ equal to the plain
    run's, the global within 1e-4."""
    import numpy as np

    from repro_torch.core import FlatSpec
    from repro_torch.data import (FederatedDataset, dirichlet_partition,
                                  make_image_classification)

    dev = torch.device("cuda")
    task = make_image_classification(seed=0, n=12000, shape=(8, 8, 1),
                                     margin=0.3, noise=1.0)
    idx, nu = dirichlet_partition(np.random.default_rng(0), task.labels,
                                  LINEAR_M, alpha=0.05, min_per_client=32)
    gen = np.random.default_rng(2)
    phi = np.concatenate([gen.uniform(0.3, 1.0, 5),
                          gen.uniform(0.02, 0.12, 5)])
    base_p = torch.from_numpy(np.clip(nu @ phi, 0.02, 1.0)
                              .astype(np.float32)).to(dev)
    params = cnn.init_mlp(prng.PRNGKey(0, dev), d_in=64, n_classes=10,
                          hidden=())
    loss_fn = cnn.make_image_loss_fn(cnn.mlp_apply)
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    runs = {}
    for use_kernel in (True, False):
        for f in flags:
            f.allow_tf32 = True
        fl = engine.FLConfig(m=LINEAR_M, s=4, strategy="fedawe",
                             use_kernel=use_kernel)
        state = engine.init_fl_state(prng.PRNGKey(0, dev), fl, params)
        tf32 = [f.allow_tf32 for f in flags]
        require(tf32 == [False, False],
                f"engine-built CUDA state left TF32 at {tf32}")
        rf = engine.make_round_fn(
            fl, loss_fn, {}, availability.AvailabilityCfg(kind="sine"),
            base_p)
        ds = FederatedDataset(dict(images=task.images, labels=task.labels),
                              idx, seed=0)

        def batch_fn(t):
            return {k: torch.from_numpy(v).to(dev)
                    for k, v in ds.round_batches(t, 4, 16).items()}

        counts.reset()
        with launch_shapes(ops) as shapes:
            state, hist = engine.run_rounds(state, rf, batch_fn,
                                            LINEAR_ROUNDS)
            torch.cuda.synchronize()
        runs[use_kernel] = (state, hist, counts.read(), shapes)
    (st, hist, launches, shapes), (pst, phist, plaunches, _) = \
        runs[True], runs[False]
    spec = FlatSpec.from_tree(st.global_tr)
    require(spec.size == LINEAR_N and spec.n_leaves == 2,
            f"linear model N = {spec.size}")
    require(launches == only(K1=LINEAR_ROUNDS) and plaunches == only()
            and set(shapes) == {(LINEAR_M, LINEAR_N)},
            f"linear launches {launches}, {plaunches} on {set(shapes)}")
    require([h["n_active"] for h in hist] == [h["n_active"] for h in phist]
            and torch.equal(st.tau, pst.tau), "linear: kernel vs plain")
    require(all(math.isfinite(h["loss"]) for h in hist), "linear: losses")
    diff = (spec.flatten(st.global_tr) - spec.flatten(pst.global_tr)).abs() \
        .max().item()
    require(diff <= 1e-4, f"linear kernel vs plain global {diff}")
    emit(dict(phase="tree_linear_path", card=smi, m=LINEAR_M, n=LINEAR_N,
              rounds=LINEAR_ROUNDS, launches=launches,
              launch_shape=[LINEAR_M, LINEAR_N], kernel_vs_plain_global=diff,
              tf32_after_engine_build=tf32,
              sum_n_active=sum(h["n_active"] for h in hist),
              last_loss=hist[-1]["loss"]))


def time_tree_route(torch, ops, ref, cnn, prng, FlatSpec, smi):
    """K1 and K2 through the tree route at [100, 27 370] over 8 rotating
    operand sets (CUDA graphs, as ``time_kernels``): the route (two
    concatenations, the launch, the unflatten views) and the flat wrapper
    on the raveled stacks in turns, the route's plain version, and the
    kernel's bound.  Returns the times per variant."""
    spec = cnn_spec(cnn, prng, FlatSpec)
    out = {}
    for variant in ("K1", "K2"):
        sets = [tree_route_inputs(torch, spec, 600 + i, variant == "K2")
                for i in range(8)]
        t = {"tree": [], "flat": []}
        for name in ("tree", "flat", "flat", "tree"):
            fn = (call_tree if name == "tree" else
                  (lambda o, a: call_kernel(o, variant, a)))
            t[name].append(graph_ms(torch, lambda i: fn(ops, sets[i % 8]),
                                    64))
        plain_ms = graph_ms(torch, lambda i: call_tree_plain(ref,
                                                             sets[i % 8]),
                            64)
        b_ms, b_by, nbytes = bound(M_MAIN, N_MAIN, 4, True, variant == "K2")
        ms = (t["tree"][0] + t["tree"][1]) / 2
        out[variant] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by)
        emit(dict(phase="kernel_time", card=smi, kernel=variant,
                  route="tree", m=M_MAIN, n=N_MAIN, leaves=spec.n_leaves,
                  ms=ms, turns_ms=t["tree"], flat_wrapper_turns_ms=t["flat"],
                  flat_wrapper_ms=(t["flat"][0] + t["flat"][1]) / 2,
                  plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                  bytes=nbytes, share=b_ms / ms))
        del sets
        torch.cuda.empty_cache()
    return out


def time_tree_rounds(torch, train, engine, federated, smi):
    """ms per round of the chunked tree and flat rounds with K1 (TREE_FLAGS
    and MAIN_FLAGS), one chunk a turn between CUDA events, in turns
    (tree, flat, flat, tree, tree, flat; each one's median compared), and
    a profiler breakdown of one tree chunk (phase 4's ``profile`` line is
    the flat chunk's)."""
    runs = {"tree": chunk_setup(torch, train, engine, federated,
                                TREE_FLAGS + ["--use-kernel"]),
            "flat": chunk_setup(torch, train, engine, federated,
                                MAIN_FLAGS + ["--use-kernel"])}
    turns = {name: [] for name in runs}
    for name in ("tree", "flat", "flat", "tree", "tree", "flat"):
        turns[name].append(chunks_ms(torch, runs[name], 1))
    median = {name: statistics.median(t) for name, t in turns.items()}
    emit(dict(phase="tree_round_time", card=smi, use_kernel=True,
              tree_ms_turns=turns["tree"], flat_ms_turns=turns["flat"],
              tree_ms=median["tree"], flat_ms=median["flat"],
              tree_over_flat=median["tree"] / median["flat"]))
    emit(dict(phase="profile", card=smi, path="tree_round", use_kernel=True,
              **profile_chunk(torch, runs["tree"], median["tree"])))
    del runs
    torch.cuda.empty_cache()
    return median


# ---------------------------------------------------------------------------
# phase 3j: MoE serving, olmoe-1b-7b and moonshot-v1-16b-a3b, K4 at head
# dim 128
# ---------------------------------------------------------------------------

#: K4's head-dim-128 checks (phase 2): olmoe-1b-7b's attention at the MoE
#: path's prefill (B 2, 16 heads, global) and mixtral-8x22b's (48 query
#: over 8 kv heads, window 4096) at one batch row; the products run over
#: all 128 head dims, no padded lanes
MOE_ATTN_CHECK = [(2, 16, 16, 8192, 8192, 128, None, 0.0, True),
                  (1, 48, 8, 8192, 8192, 128, 4096, 0.0, True)]
OLMOE_ATTN = MOE_ATTN_CHECK[0]
MOE_ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b", "mixtral-8x22b")
#: moe_vs_dense: the prompt's length, and the bound (tests/test_moe.py:28)
#: as a share of each layer's largest dense output
MOE_DENSE_L, MOE_DENSE_TOL = 2048, 2e-4
#: moe_flash_vs_xla: with the xla run's routing pinned to the flash run's
#: experts, a token whose own top-k set differs from the pinned one must
#: be a near tie of its router (its k-th and (k+1)-th logits within
#: ROUTE_TIE; the attention outputs that feed the router differ by about
#: 1e-5 between the two branches)
ROUTE_TIE = 1e-4
#: kernel-name substrings of the MoE profiles' parts (first match wins):
#: the router's softmax and top-k (with its in-place sorts), the
#: dispatch's stable sort, searchsorted, gathers and scatters
MOE_PARTS = {"K4": ("flash_fwd",),
             "cublas": ("nvjet", "gemm", "cutlass", "sm90_xmma"),
             "router": ("softmax", "topk", "sortkvinplace",
                        "sortkeyvalueinplace"),
             "dispatch": ("radixsort", "onesweep", "sort", "searchsorted",
                          "indexselect", "index_select", "scatter",
                          "gather")}


def tree_bytes(tree):
    """Bytes of a nested dict's tensors."""
    return sum(tree_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def full_config(get_config, arch, dtype):
    """``arch`` at its published widths and depth in ``dtype`` with
    attn_backend="flash", nothing cut."""
    return get_config(arch).replace(dtype=dtype, attn_backend="flash")


@contextlib.contextmanager
def moe_layers(model, fn):
    """Inside the block every MoE layer of the port's model (the
    ``model.moe_ffn`` call of its own layer loop) runs
    ``fn(moe_ffn, x, bp, cfg)`` in its place."""
    orig = model.moe_ffn
    model.moe_ffn = lambda x, bp, cfg: fn(orig, x, bp, cfg)
    try:
        yield
    finally:
        model.moe_ffn = orig


def kept_slots(moe, x, bp, cfg):
    """The kept slots [B L, k] of a layer's routing of x [B, L, d] at
    cfg's capacity."""
    B, L, _ = x.shape
    _, topi, _ = moe._route(x, bp["router"], cfg.top_k)
    _, _, keep = moe.dispatch(topi, cfg.n_experts, moe.capacity(cfg, L))
    return keep.view(B * L, -1)


@contextlib.contextmanager
def pinned_routes(torch, moe, record, replay=None):
    """Inside the block ``moe_ffn``'s router (``moe._route``, called once
    per MoE layer of the model's own loop) appends each layer's top-k
    experts to ``record``.  With ``replay`` (an earlier run's record) each
    layer routes to the replayed experts instead, weighted by its own
    probabilities there renormalised, and ``record`` gets the experts it
    would have chosen and the gap between its k-th and (k+1)-th router
    logits."""
    orig = moe._route

    def route(x, router_w, top_k):
        topw, topi, aux = orig(x, router_w, top_k)
        if replay is None:
            record.append(topi)
            return topw, topi, aux
        pinned = replay[len(record)]
        logits = x.float() @ router_w.float()
        top = logits.topk(top_k + 1, dim=-1).values
        record.append((topi, top[..., -2] - top[..., -1]))
        w = torch.softmax(logits, dim=-1).gather(-1, pinned)
        return w / w.sum(-1, keepdim=True), pinned, aux

    moe._route = route
    try:
        yield
    finally:
        moe._route = orig


def moe_repeat(torch, model, moe, cfg, params, tokens, first):
    """A second prefill of the main path's prompts into a new cache, each
    MoE layer's kept slots recorded on the way: logits and every cache
    leaf over the prompt's slots bit-equal to the main path's prefill
    (``first``: its logits and cache).  Returns each layer's share of
    dropped slots at cfg's capacity factor."""
    dropped = []

    def fn(orig, x, bp, c):
        dropped.append(1.0 - kept_slots(moe, x, bp, c).float().mean().item())
        return orig(x, bp, c)

    cache = model.init_cache(cfg, LM_B, LM_L + LM_NEW)
    with moe_layers(model, fn):
        logits, cache = model.prefill(params, cfg, cache, tokens)
    torch.cuda.synchronize()
    first_logits, first_cache = first
    require(torch.equal(logits, first_logits),
            f"{cfg.name}: a second prefill's logits differ in bits")
    require(all(torch.equal(a[name][:, :, :LM_L], b[name][:, :, :LM_L])
                for a, b in zip(cache["stack"].values(),
                                first_cache["stack"].values())
                for name in a) and not cache["tail"],
            f"{cfg.name}: a second prefill's cache differs in bits")
    require(len(dropped) == cfg.n_layers, f"{len(dropped)} MoE layers")
    return dropped


def moe_vs_dense(torch, model, moe, cfg, params, tokens, smi):
    """olmoe-1b-7b at full width in float32 (B 1, the first MOE_DENSE_L
    prompt tokens), inside the model's own layer loop: each MoE layer's
    ``moe_ffn`` at cf = E (nothing dropped) against ``moe_ffn_dense_ref``
    on the same input, within MOE_DENSE_TOL as a share of the dense
    output's largest element; at cfg's cf (1.25) the tokens whose k slots
    were all kept within the same bound.  The run goes on with the cf 1.25
    output."""
    rec = []

    def fn(orig, x, bp, c):
        y, aux = orig(x, bp, c)
        dense, _ = moe.moe_ffn_dense_ref(x, bp, c)
        scale = dense.abs().max()
        whole = kept_slots(moe, x, bp, c).all(-1)
        kept = (y - dense).abs().amax(-1).reshape(-1)[whole].max()
        nodrop, _ = orig(x, bp, c.replace(capacity_factor=float(
            c.n_experts)))
        rec.append(dict(nodrop=((nodrop - dense).abs().max() / scale).item(),
                        kept=(kept / scale).item(),
                        whole_share=whole.float().mean().item(),
                        absmax=scale.item()))
        return y, aux

    cache = model.init_cache(cfg, 1, MOE_DENSE_L)
    with moe_layers(model, fn):
        model.prefill(params, cfg, cache, tokens[:1, :MOE_DENSE_L])
    torch.cuda.synchronize()
    del cache
    worst = {key: max(r[key] for r in rec) for key in ("nodrop", "kept")}
    emit(dict(phase="moe_vs_dense", card=smi, arch=cfg.name,
              dtype=cfg.dtype, batch=1, prompt=MOE_DENSE_L, tol=MOE_DENSE_TOL,
              capacity_factor=cfg.capacity_factor,
              nodrop_rel=[r["nodrop"] for r in rec],
              kept_rel=[r["kept"] for r in rec],
              tokens_all_kept_share=[r["whole_share"] for r in rec],
              dense_absmax=[r["absmax"] for r in rec], worst=worst))
    require(len(rec) == cfg.n_layers, f"{len(rec)} MoE layers")
    require(max(worst.values()) <= MOE_DENSE_TOL,
            f"moe_ffn vs moe_ffn_dense_ref: {worst} > {MOE_DENSE_TOL}")
    torch.cuda.empty_cache()


def moe_flash_vs_xla(torch, model, moe, cfg, params, tokens, smi):
    """olmoe-1b-7b in float32 (B 1, the bf16 weights upcast): the flash
    prefill against the xla branch's, with the xla run's routing pinned
    to the flash run's experts (``pinned_routes``).  A router is
    discontinuous: free-running, a top-k near tie that the two branches'
    1e-5 attention differences tip sends a token to other experts, its
    hidden state moves by tenths, and the change spreads through the
    later layers' attention and capacity ranks.  Pinned, the comparison
    holds what the flash kernel changes: each layer's attention output on
    the same input (``both_backends``), the logits and every cache leaf
    within LM_TOL_F32, the positions equal; and every token whose own
    top-k set in the xla run differs from the pinned one must be a near
    tie there (its k-th and (k+1)-th logits within ROUTE_TIE)."""
    tok = tokens[:1]
    routes, own, layers, runs = [], [], [], {}
    for backend in ("flash", "xla"):
        c = cfg.replace(attn_backend=backend)
        cache = model.init_cache(c, 1, LM_L + LM_NEW)
        with contextlib.ExitStack() as stack:
            if backend == "flash":
                stack.enter_context(pinned_routes(torch, moe, routes))
            else:
                stack.enter_context(pinned_routes(torch, moe, own, routes))
                stack.enter_context(both_backends(model, layers))
            runs[backend] = model.prefill(params, c, cache, tok)
        torch.cuda.synchronize()
    (lf, cf), (lx, cx) = runs["flash"], runs["xla"]
    require(len(routes) == len(own) == cfg.n_layers,
            f"{len(routes)}, {len(own)} MoE layer calls")
    flips, gaps = [], []
    for pinned, (topi, gap) in zip(routes, own):
        member = (topi[..., :, None] == pinned[..., None, :]).any(-1)
        flip = ~member.all(-1)
        flips.append(int(flip.sum()))
        gaps.append(gap[flip].max().item() if flips[-1] else 0.0)
    for key in cf["stack"]:
        require(torch.equal(cf["stack"][key]["pos"], cx["stack"][key]["pos"]),
                "cache positions")
    d = dict(attn_layers=[e for e, _ in layers],
             attn_layer_absmax=[m for _, m in layers],
             logits=(lf - lx).abs().max().item(),
             logits_absmax=lx.abs().max().item(),
             cache=max((a - b).abs().max().item()
                       for a, b in zip(cache_kv(cf), cache_kv(cx))),
             topk_differs=flips, topk_differs_gap_max=gaps)
    emit(dict(phase="moe_flash_vs_xla", card=smi, arch=cfg.name,
              dtype=cfg.dtype, batch=1, prompt=LM_L, tol=LM_TOL_F32,
              route_tie=ROUTE_TIE,
              routing="xla run pinned to the flash run's experts", **d))
    require(max(d["attn_layers"]) <= LM_TOL_F32,
            f"flash vs xla attention per layer (float32): {d['attn_layers']}")
    require(max(gaps) <= ROUTE_TIE,
            f"a top-k set differs at a router gap of {max(gaps)}")
    require(d["logits"] <= LM_TOL_F32 and d["cache"] <= LM_TOL_F32,
            f"flash vs xla prefill (float32): logits {d['logits']}, "
            f"caches {d['cache']} > {LM_TOL_F32}")
    del runs, lf, cf, lx, cx, routes, own
    torch.cuda.empty_cache()


def moe_parity_small(torch, model, get_config, reduced, smi):
    """On the card at a small size: reduced olmoe-1b-7b,
    moonshot-v1-16b-a3b and mixtral-8x22b (fl_mode="full"), float32,
    flash backend, cf = E (nothing dropped: which slots an expert drops
    depends on the sequence's length, so a prefill and the full forward
    drop different ones; tests/test_decode_parity.py's moe family runs at
    cf = E for that reason): prefill of 128 tokens then 16 decode steps
    against the full forward over all 144, within 1e-3."""
    worst = {}
    for i, arch in enumerate(MOE_ARCHS):
        cfg = reduced(get_config(arch))
        cfg = cfg.replace(attn_backend="flash", fl_mode="full",
                          capacity_factor=float(cfg.n_experts))
        params = lm_weights(torch, model, cfg, seed=20 + i)
        gen = torch.Generator(device="cuda").manual_seed(30 + i)
        toks = torch.randint(0, cfg.vocab, (2, 144), generator=gen,
                             device="cuda")
        h, _ = model.forward_hidden(params, cfg, toks)
        full = model.lm_logits(h, params, cfg)
        cache = model.init_cache(cfg, 2, 144)
        logits, cache = model.prefill(params, cfg, cache, toks[:, :128])
        errs = [(logits - full[:, 127]).abs().max().item()]
        for t in range(128, 144):
            logits, cache = model.serve_step(
                params, cfg, cache, toks[:, t:t + 1],
                torch.full((2,), t, device="cuda"))
            errs.append((logits - full[:, t]).abs().max().item())
        worst[arch] = max(errs)
    emit(dict(phase="moe_parity_small", card=smi, max_abs_err=worst,
              tol=1e-3))
    require(max(worst.values()) < 1e-3, f"MoE decode parity {worst}")


def serve_cli(serve, smi, archs, phase):
    """``launch.serve``'s CLI on the card for the reduced ``archs`` (its
    default): every request finishes and prints its tokens (the CLI's own
    output is kept off this script's standard output)."""
    stats = {}
    for arch in archs:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            stats[arch] = serve.main(["--arch", arch, "--requests", "3",
                                      "--slots", "2", "--max-new", "4"])
        require(all(f"req{i}: " in out.getvalue() for i in range(3)),
                f"{arch}: the serve CLI printed {out.getvalue()!r}")
    emit(dict(phase=phase, card=smi, stats=stats))


def moe_paths(torch, model, moe, serve, get_config, reduced, counts, smi):
    """Phase 3j, with its numbers: olmoe-1b-7b's main path (every count
    at 0 just before), a repeated prefill, its times; then in float32
    moe_vs_dense and moe_flash_vs_xla; then moonshot-v1-16b-a3b's main
    path and times (olmoe's weights freed first); then the small decode
    parity and the serve CLI.  Returns the two main paths' launches."""
    t0 = time.perf_counter()
    launches = {}
    cfg = full_config(get_config, "olmoe-1b-7b", "bfloat16")
    params = lm_weights(torch, model, cfg, seed=11)
    tokens = lm_tokens(torch, cfg.vocab, seed=12)
    launches[cfg.name], logits, cache = lm_main_path(
        torch, model, cfg, params, tokens, counts, cfg.n_layers,
        "moe_main_path", card=smi)
    dropped = moe_repeat(torch, model, moe, cfg, params, tokens,
                         (logits, cache))
    del logits, cache
    emit(dict(phase="moe_repeat", card=smi, arch=cfg.name, bit_equal=True,
              capacity_factor=cfg.capacity_factor,
              capacity=moe.capacity(cfg, LM_L),
              dropped_share_per_layer=dropped))
    time_serve(torch, model, cfg, params, tokens, smi, "olmoe", MOE_PARTS)
    c32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda k, t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    moe_vs_dense(torch, model, moe, c32, p32, tokens, smi)
    moe_flash_vs_xla(torch, model, moe, c32, p32, tokens, smi)
    del p32
    torch.cuda.empty_cache()

    cfg = full_config(get_config, "moonshot-v1-16b-a3b", "bfloat16")
    torch.cuda.reset_peak_memory_stats()
    params = lm_weights(torch, model, cfg, seed=13)
    tokens = lm_tokens(torch, cfg.vocab, seed=14)
    launches[cfg.name], _, cache = lm_main_path(
        torch, model, cfg, params, tokens, counts, cfg.n_layers,
        "moonshot_main_path", card=smi)
    emit(dict(phase="moonshot_memory", card=smi,
              weights_gb=tree_bytes(params) / 1e9,
              cache_gb=tree_bytes(cache) / 1e9,
              peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9))
    del cache
    torch.cuda.empty_cache()
    time_serve(torch, model, cfg, params, tokens, smi, "moonshot",
               MOE_PARTS)
    del params
    torch.cuda.empty_cache()
    moe_parity_small(torch, model, get_config, reduced, smi)
    serve_cli(serve, smi, MOE_ARCHS[:2], "moe_serve_cli")
    emit(dict(phase="moe_paths_done", card=smi,
              seconds=time.perf_counter() - t0))
    return launches


# ---------------------------------------------------------------------------
# phase 3k: encoder-decoder and modality-frontend serving,
# seamless-m4t-large-v2 and internvl2-2b, K4 at head dim 64 and at head
# dim 128 with grouped queries
# ---------------------------------------------------------------------------

#: K4's checks at the two prefills (phase 2), whole: seamless-m4t-large-
#: v2's decoder self-attention (B 2, 16 heads of 64, global) through the
#: kernel's head-dim-64 build, and internvl2-2b's (16 query over 8 kv
#: heads of 128: G = 2) through its head-dim-128 build
ENCDEC_ATTN_CHECK = [(2, 16, 16, 8192, 8192, 64, None, 0.0, True),
                     (2, 16, 8, 8192, 8192, 128, None, 0.0, True)]
SEAMLESS_ATTN, INTERNVL_ATTN = ENCDEC_ATTN_CHECK
ENCDEC_ARCHS = ("seamless-m4t-large-v2", "internvl2-2b")
#: the profiles' parts by kernel name; the encoder's attention and the
#: decoder's cross-attention (plain torch, K/V projections included)
#: count apart as ranges (``encdec_paths``)
ENCDEC_PARTS = {"K4": ("flash_fwd",),
                "cublas": ("nvjet", "gemm", "cutlass", "sm90_xmma")}


def encdec_inputs(torch, cfg, batch, seed):
    """The stub frontends' outputs, N(0, 1) in cfg.dtype drawn from
    ``seed``: an enc-dec model's ``enc_embeds`` [batch, enc_len, d] (audio
    frames) and a frontend model's ``embeds`` [batch, frontend_len, d]
    (image patches, in place of the first frontend_len tokens)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    shapes = {}
    if cfg.enc_dec:
        shapes["enc_embeds"] = (batch, cfg.enc_len, cfg.d_model)
    if cfg.frontend != "none":
        shapes["embeds"] = (batch, cfg.frontend_len, cfg.d_model)
    return {k: torch.randn(*shape, generator=gen, device="cuda").to(dt)
            for k, shape in shapes.items()}


def encdec_repeat(torch, model, cfg, params, tokens, inputs, first):
    """A second prefill of the main path's inputs into a new cache: the
    logits and every cache leaf over the prompt's slots, the encoder
    output included, bit-equal to the main path's prefill (``first``:
    its logits and cache)."""
    cache = model.init_cache(cfg, LM_B, LM_L + LM_NEW)
    logits, cache = model.prefill(params, cfg, cache, tokens, **inputs)
    torch.cuda.synchronize()
    first_logits, first_cache = first
    require(torch.equal(logits, first_logits),
            f"{cfg.name}: a second prefill's logits differ in bits")
    require(all(torch.equal(a[name][:, :, :LM_L], b[name][:, :, :LM_L])
                for a, b in zip(cache["stack"].values(),
                                first_cache["stack"].values())
                for name in a) and not cache["tail"]
            and cache.keys() == first_cache.keys()
            and ("enc_out" not in cache
                 or torch.equal(cache["enc_out"], first_cache["enc_out"])),
            f"{cfg.name}: a second prefill's cache differs in bits")


def encdec_flash_vs_xla(torch, model, cfg, params, tokens, inputs, smi):
    """In float32 (B 1, the bf16 weights and inputs upcast): the flash
    prefill against the xla branch's, each layer's attention sub-block on
    the same input (``both_backends``: self-attention, and for an enc-dec
    model the cross-attention, which runs the plain attention in both),
    the logits and every cache leaf (the encoder output included) within
    LM_TOL_F32."""
    d = prefill_drift(torch, model, cfg, params, tokens, LM_L + LM_NEW,
                      inputs)
    d.pop("runs")
    emit(dict(phase="encdec_flash_vs_xla", card=smi, arch=cfg.name,
              dtype=cfg.dtype, batch=1, prompt=LM_L, tol=LM_TOL_F32, **d))
    require(max(d["layers"]) <= LM_TOL_F32 and d["logits"] <= LM_TOL_F32
            and d["cache"] <= LM_TOL_F32,
            f"{cfg.name} flash vs xla (float32): attention "
            f"{max(d['layers'])}, logits {d['logits']}, caches {d['cache']} "
            f"> {LM_TOL_F32}")
    torch.cuda.empty_cache()


def encdec_parity_small(torch, model, get_config, reduced, smi):
    """On the card at a small size: reduced seamless-m4t-large-v2 and
    internvl2-2b (float32, flash backend) with their stub inputs: prefill
    of 128 tokens then 16 decode steps against the full forward over all
    144, within 1e-3 (tests/test_decode_parity.py)."""
    worst = {}
    for i, arch in enumerate(ENCDEC_ARCHS):
        cfg = reduced(get_config(arch)).replace(attn_backend="flash")
        params = lm_weights(torch, model, cfg, seed=40 + i)
        inputs = encdec_inputs(torch, cfg, 2, seed=42 + i)
        gen = torch.Generator(device="cuda").manual_seed(44 + i)
        toks = torch.randint(0, cfg.vocab, (2, 144), generator=gen,
                             device="cuda")
        h, _ = model.forward_hidden(params, cfg, toks, **inputs)
        full = model.lm_logits(h, params, cfg)
        cache = model.init_cache(cfg, 2, 144)
        logits, cache = model.prefill(params, cfg, cache, toks[:, :128],
                                      **inputs)
        errs = [(logits - full[:, 127]).abs().max().item()]
        for t in range(128, 144):
            logits, cache = model.serve_step(
                params, cfg, cache, toks[:, t:t + 1],
                torch.full((2,), t, device="cuda"))
            errs.append((logits - full[:, t]).abs().max().item())
        worst[arch] = max(errs)
    emit(dict(phase="encdec_parity_small", card=smi, max_abs_err=worst,
              tol=1e-3))
    require(max(worst.values()) < 1e-3, f"enc-dec decode parity {worst}")


def encdec_paths(torch, model, serve, get_config, reduced, counts, smi):
    """Phase 3k, with its numbers.  For seamless-m4t-large-v2, then
    internvl2-2b (each one's weights freed before the next), at its
    published widths and depth in bfloat16 with attn_backend="flash" and
    its stub inputs from a seed: the main path (every count at 0 just
    before: K4 once per decoder layer in the prefill, never in decode), a
    repeated prefill, prefill and decode ms with a profile by part (K4,
    cuBLAS, the encoder's attention, the cross-attention, the rest) and
    the encoder's ms; then in float32 ``encdec_flash_vs_xla``.  Then the
    small decode parity and the serve CLI.  Returns the main paths'
    launches."""
    t0 = time.perf_counter()
    launches = {}
    ranges = {"encoder_attention": (model, "attention"),
              "cross_attention": (model, "_cross_attn")}
    for i, arch in enumerate(ENCDEC_ARCHS):
        tag = arch.split("-")[0]
        cfg = full_config(get_config, arch, "bfloat16")
        params = lm_weights(torch, model, cfg, seed=15 + 3 * i)
        tokens = lm_tokens(torch, cfg.vocab, seed=16 + 3 * i)
        inputs = encdec_inputs(torch, cfg, LM_B, seed=17 + 3 * i)
        launches[arch], logits, cache = lm_main_path(
            torch, model, cfg, params, tokens, counts, cfg.n_layers,
            f"{tag}_main_path", inputs=inputs, card=smi,
            encoder_layers=cfg.n_enc_layers if cfg.enc_dec else 0,
            inputs_shape={k: list(v.shape) for k, v in inputs.items()})
        encdec_repeat(torch, model, cfg, params, tokens, inputs,
                      (logits, cache))
        del logits, cache
        emit(dict(phase=f"{tag}_repeat", card=smi, arch=cfg.name,
                  bit_equal=True))
        time_serve(torch, model, cfg, params, tokens, smi, tag, ENCDEC_PARTS,
                   inputs=inputs, ranges=ranges)
        if cfg.enc_dec:
            emit(dict(phase="encode_time", card=smi, arch=cfg.name,
                      frames=list(inputs["enc_embeds"].shape),
                      encode_ms=events_ms(torch, lambda: model.encode(
                          params, cfg, inputs["enc_embeds"]), 5)))
        c32 = cfg.replace(dtype="float32")
        p32 = tree_map(lambda k, t: t.float(), params)
        del params
        torch.cuda.empty_cache()
        encdec_flash_vs_xla(torch, model, c32, p32, tokens[:1],
                            {k: v[:1].float() for k, v in inputs.items()},
                            smi)
        del p32
        torch.cuda.empty_cache()
    encdec_parity_small(torch, model, get_config, reduced, smi)
    serve_cli(serve, smi, ENCDEC_ARCHS, "encdec_serve_cli")
    emit(dict(phase="encdec_paths_done", card=smi,
              seconds=time.perf_counter() - t0))
    return launches


# ---------------------------------------------------------------------------
# phase 3l: full-parameter federated LM training, K1 on the LM's stack
# ---------------------------------------------------------------------------

#: ``train --preset lm`` (fl-lm-tiny on the synthetic token streams)
LM_TRAIN_FLAGS = ["--preset", "lm", "--strategy", "fedawe", "--chunk-rounds",
                  "4", "--rounds", "8", "--m", "6", "--s", "2", "--batch",
                  "8", "--device", "cuda"]
#: the full-width run: clients, local steps (mamba2-130m's local_steps),
#: sequences per client per step and their length, rounds in the chunk
LM_FULL_ARCH = "mamba2-130m"
LM_FULL_M, LM_FULL_S, LM_FULL_B, LM_FULL_L, LM_FULL_K = 8, 2, 2, 1024, 4
#: sequences each client owns in the full-width run's store
LM_FULL_PER_CLIENT = 8
#: one FedAWE round of the reduced architectures (tests/test_archs.py's)
LM_SMALL_M, LM_SMALL_S, LM_SMALL_B, LM_SMALL_L = 4, 2, 2, 16
#: kernel-name substrings of the full-width training round's parts
LM_TRAIN_PARTS = {"K1": ("echo_aggregate",),
                  "fp32_gemm": ("f32f32", "sgemm"),
                  "cublas": ("nvjet", "gemm", "cutlass", "sm90_xmma",
                             "gemv"),
                  "conv": ("conv", "cudnn"),
                  "cumsum": ("cumsum", "scan"),
                  "copy": ("copy",),
                  "reduce": ("reduce",),
                  "elementwise": ("elementwise",)}


def lm_history_close(a, b, tol=1e-4):
    """Largest difference between two runs' per-round metrics (the same
    keys, the same number of rounds required)."""
    require(len(a) == len(b) and all(sorted(x) == sorted(y)
                                      for x, y in zip(a, b)),
            "histories differ in length or keys")
    return max(abs(x[k] - y[k]) for x, y in zip(a, b) for k in x)


def lm_train_cli_path(torch, train, counts, smi):
    """``train --preset lm`` on the card: FedAWE on the flat state with
    the kernel (K1 once a round), and under ``--midround-drop 0.3`` (K2
    once a round); each against the same seed on tree state with the
    kernel and on the flat state without it: per-round metrics and the
    final eval loss within 1e-4."""
    parser = train.build_parser()
    for tag, extra, key in (("fault_free", [], "K1"),
                            ("midround", ["--midround-drop", "0.3"], "K2")):
        runs = {}
        for route, flags in (
                ("flat_kernel", ["--flat-state", "--use-kernel"]),
                ("tree_kernel", ["--use-kernel"]),
                ("flat_plain", ["--flat-state"])):
            counts.reset()
            state, hist, final = train.run(
                parser.parse_args(LM_TRAIN_FLAGS + extra + flags))
            torch.cuda.synchronize()
            runs[route] = (hist, final, counts.read())
        hist, final, launches = runs["flat_kernel"]
        rounds = len(hist)
        want = dict(K1=0, K2=0, K3=0, K4=0, K5=0)
        want[key] = rounds
        require(launches == want, f"lm {tag} launches {launches}")
        require(runs["tree_kernel"][2] == want,
                f"lm {tag} tree launches {runs['tree_kernel'][2]}")
        require(runs["flat_plain"][2] == dict(want, **{key: 0}),
                f"lm {tag} plain launches {runs['flat_plain'][2]}")
        require(all(math.isfinite(h["loss"]) for h in hist),
                f"lm {tag} losses {hist}")
        diffs = {}
        for route in ("tree_kernel", "flat_plain"):
            diffs[route] = max(
                lm_history_close(hist, runs[route][0]),
                abs(final["eval_loss"] - runs[route][1]["eval_loss"]))
            require(diffs[route] <= 1e-4,
                    f"lm {tag}: {route} differs by {diffs[route]}")
        emit(dict(phase="lm_train_cli", card=smi, run=tag, rounds=rounds,
                  launches=launches, first_loss=hist[0]["loss"],
                  last_loss=hist[-1]["loss"], eval_loss=final["eval_loss"],
                  max_diff=diffs, tol=1e-4))


def lm_full_setup(torch, np, model, engine, federated, availability, prng,
                  cfg, seed):
    """The full-width FedAWE run of ``cfg`` built from the engine, as
    tests/test_archs.py's round is: ``lm_loss`` over
    ``merge_trainable`` (``model.lm_loss_fn``), FedAWE with the kernel on
    the flat state, m clients at p = 0.8, s local steps at eta_l 0.01
    without schedule or clip; the weights from ``init_params`` under
    ``seed``; a device store of synthetic tokens (uniform over the
    vocabulary, drawn with numpy from ``seed``), ``LM_FULL_PER_CLIENT``
    sequences of L + 1 tokens per client, batches of B sequences per
    client per step from the uniform sampler."""
    m, s, b, L = LM_FULL_M, LM_FULL_S, LM_FULL_B, LM_FULL_L
    gen = torch.Generator(device="cuda").manual_seed(seed)
    trainable, frozen = model.split_trainable(model.init_params(gen, cfg),
                                              cfg)
    fl = engine.FLConfig(m=m, s=s, eta_l=0.01, eta_g=1.0, strategy="fedawe",
                         lr_schedule=False, grad_clip=0.0, flat_state=True,
                         use_kernel=True)
    state = engine.init_fl_state(prng.PRNGKey(seed, "cuda"), fl, trainable)
    g0 = state.global_tr.clone()
    del trainable
    round_fn = engine.make_round_fn(
        fl, model.lm_loss_fn(cfg), frozen,
        availability.AvailabilityCfg(kind="stationary"),
        torch.full((m,), 0.8, device="cuda"))
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (m * LM_FULL_PER_CLIENT, L + 1)).astype(np.int32)
    store = federated.device_store(
        dict(tokens=toks[:, :-1], labels=toks[:, 1:]), None, "cuda",
        padded=federated.contiguous_client_index(m, LM_FULL_PER_CLIENT))
    init, sample = federated.make_device_sampler(
        m, s, b, min_count=LM_FULL_PER_CLIENT)
    key = prng.PRNGKey(seed + 1, "cuda")
    return dict(state=state, g0=g0, round_fn=round_fn, store=store,
                ss=init(store, key), sample=sample, key=key, fl=fl)


def lm_full_width_path(torch, np, model, engine, federated, availability,
                       prng, ops, ref, get_config, counts, smi):
    """mamba2-130m at its published widths and depth (24 layers, d_model
    768, vocab 50 280; 1.29e8 parameters) in bfloat16 with remat, trained
    with full parameters by FedAWE on the flat [8, N] float32 state with
    K1: round 1 alone (after it every trainable leaf of the global has
    moved, so no weight lost its gradient), then the main path, 4 rounds
    in one chunk between CUDA events with every count at 0 just before it
    (K1 4 times, K5 never: training runs the plain SSD scan), its peak
    memory, then one profiled round (busy share, launches, parts).
    Every loss finite.  Then K1 alone at the stack's [8, N] float32 shape:
    against its plain version (1e-5) and timed beside it and its bound.
    Returns the kernels-line record of K1 at [8, N]."""
    cfg = get_config(LM_FULL_ARCH)
    t0 = time.perf_counter()
    r = lm_full_setup(torch, np, model, engine, federated, availability,
                      prng, cfg, seed=40)
    n = r["state"].spec.size
    require(n == model.count_params(cfg, trainable_only=True),
            f"stack width {n}")
    perf_drops = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        counts.reset()
        one = engine.make_chunk_fn(None, r["round_fn"], r["sample"], 1)
        state, ss, met1 = one(r["state"], r["ss"], r["store"], r["key"])
        torch.cuda.synchronize()
        first = counts.read()
        require(first["K5"] == 0 and first["K1"] == 1,
                f"round 1 launches {first}")
        spec, g0, g1 = state.spec, r.pop("g0"), state.global_tr
        still = ["/".join(p) for p, o, k in zip(spec.paths, spec.offsets,
                                                spec.sizes)
                 if torch.equal(g0[o:o + k], g1[o:o + k])]
        require(not still, f"leaves that did not move in round 1: {still}")
        del g0, g1
        chunk = engine.make_chunk_fn(None, r["round_fn"], r["sample"],
                                     LM_FULL_K)
        torch.cuda.reset_peak_memory_stats()
        counts.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, ss, met = chunk(state, ss, r["store"], r["key"])
        end.record()
        end.synchronize()
        launches = counts.read()
        round_ms = start.elapsed_time(end) / LM_FULL_K
        peak = torch.cuda.max_memory_allocated()
        require(launches == dict(K1=LM_FULL_K, K2=0, K3=0, K4=0, K5=0),
                f"full-width launches {launches}")
        losses = [met1["loss"].item()] + met["loss"].tolist()
        require(all(math.isfinite(v) for v in losses), f"losses {losses}")
        require(bool(torch.isfinite(state.global_tr).all()),
                "global not finite")
        box = {}

        def profiled():
            box["out"] = one(state, ss, r["store"], r["key"])

        prof = profile_ms(torch, profiled, parts=LM_TRAIN_PARTS)
        if prof["device_ms"]:
            prof["parts_ms"]["rest"] = (prof["device_ms"]
                                        - sum(prof["parts_ms"].values()))
        losses.append(box["out"][2]["loss"].item())
        perf_drops = sorted({str(w.message)[:120] for w in caught
                             if "performance drop" in str(w.message)})
    emit(dict(phase="lm_full_width", card=smi, arch=cfg.name,
              dtype=cfg.dtype, remat=cfg.remat,
              remat_policy=cfg.remat_policy, params=n, m=LM_FULL_M,
              s=LM_FULL_S, batch=LM_FULL_B, seq=LM_FULL_L,
              rounds=LM_FULL_K, launches=launches, round_ms=round_ms,
              peak_allocated_gb=peak / 1e9,
              state_gb=(r["fl"].m + 2) * n * 4 / 1e9, losses=losses,
              n_active=met["n_active"].tolist(),
              profiled_round=dict(
                  prof, busy_share=(prof["device_ms"] / round_ms
                                    if prof["device_ms"] else None)),
              vmap_fallbacks=perf_drops))
    model_flops_share(cfg, LM_FULL_M * LM_FULL_S * LM_FULL_B * LM_FULL_L,
                      "train", round_ms, smi, "lm_full_width_round")
    del state, ss, r, box, chunk, one
    torch.cuda.empty_cache()
    rec = lm_k1_at_stack(torch, ops, ref, n, smi)
    rec["launches"] = launches["K1"]
    emit(dict(phase="lm_full_width_done", card=smi,
              seconds=time.perf_counter() - t0))
    return rec


def lm_k1_at_stack(torch, ops, ref, n, smi, m=LM_FULL_M):
    """K1 alone at an LM stack's shape, [m, n] float32 (x, y, g, mask and
    echo drawn from a seed): against its plain version on the same inputs
    (1e-5), and its time, the plain version's and the bound (each input
    read once, the output written once)."""
    a = make_inputs(torch, m, n, torch.float32, seed=41)
    got = call_kernel(ops, "K1", a)
    want = call_plain(ref, "K1", a)
    err = (got - want).abs().max().item()
    del got, want
    require(err <= 1e-5, f"K1 at [{m}, {n}]: {err}")
    ms = [events_ms(torch, lambda: call_kernel(ops, "K1", a), 5)]
    plain_ms = events_ms(torch, lambda: call_plain(ref, "K1", a), 3)
    ms.append(events_ms(torch, lambda: call_kernel(ops, "K1", a), 5))
    b_ms, b_by, nbytes = bound(m, n, 4, True)
    rec = dict(ms=sum(ms) / 2, turns_ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=err)
    emit(dict(phase="kernel_time", card=smi, kernel="K1", m=m, n=n,
              bytes=nbytes, share=b_ms / rec["ms"],
              achieved_gb_per_s=nbytes / rec["ms"] / 1e6, **rec))
    del a
    torch.cuda.empty_cache()
    return rec


def lm_small_round(torch, np, model, engine, availability, prng, cfg,
                   device, seed):
    """One FedAWE round of ``cfg`` (m 4, s 2, B 2, L 16, flat state with
    the kernel route) on ``device`` from the same weights and batch (a
    LoRA config's frozen base closed over the round): returns (loss,
    global [N] on the CPU)."""
    m, s = LM_SMALL_M, LM_SMALL_S
    gen = torch.Generator().manual_seed(seed)
    params, frozen = (tree_map(lambda k, t: t.to(device), tree)
                      for tree in model.split_trainable(
                          model.init_params(gen, cfg), cfg))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (LM_SMALL_B, LM_SMALL_L))
    b = dict(tokens=toks, labels=toks,
             mask=np.ones((LM_SMALL_B, LM_SMALL_L), np.float32))
    if cfg.frontend != "none":
        b["embeds"] = rng.normal(size=(LM_SMALL_B, cfg.frontend_len,
                                       cfg.d_model)).astype(np.float32)
        b["mask"][:, :cfg.frontend_len] = 0.0
    if cfg.enc_dec:
        b["enc_embeds"] = rng.normal(size=(LM_SMALL_B, cfg.enc_len,
                                           cfg.d_model)).astype(np.float32)
    batches = {k: torch.from_numpy(np.broadcast_to(
        v[None, None], (m, s) + v.shape).copy()).to(device)
        for k, v in b.items()}
    fl = engine.FLConfig(m=m, s=s, eta_l=0.01, eta_g=1.0, strategy="fedawe",
                         lr_schedule=False, grad_clip=0.0, flat_state=True,
                         use_kernel=True)
    state = engine.init_fl_state(prng.PRNGKey(seed, device), fl, params)
    round_fn = engine.make_round_fn(
        fl, model.lm_loss_fn(cfg), frozen,
        availability.AvailabilityCfg(kind="stationary"),
        torch.full((m,), 0.8, device=device))
    state, met = round_fn(state, batches)
    return met["loss"].item(), state.global_tr.cpu()


def lm_small_paths(torch, np, model, engine, availability, prng, get_config,
                   reduced, counts, smi):
    """Every architecture of the registry at ``reduced()`` (float32), in
    its own ``fl_mode`` (gemma3-27b and mixtral-8x22b train their
    adapters over a frozen base): one FedAWE round on the card (K1 once)
    and the same round on the CPU port, loss and global within 1e-4."""
    from repro_torch.configs import _MODULES

    worst = {}
    for i, arch in enumerate(_MODULES):
        cfg = reduced(get_config(arch))
        counts.reset()
        loss_c, g_c = lm_small_round(torch, np, model, engine, availability,
                                     prng, cfg, "cuda", seed=50 + i)
        launches = counts.read()
        loss_h, g_h = lm_small_round(torch, np, model, engine, availability,
                                     prng, cfg, "cpu", seed=50 + i)
        require(launches == dict(K1=1, K2=0, K3=0, K4=0, K5=0),
                f"{arch} round launches {launches}")
        worst[arch] = dict(mode=cfg.fl_mode, n=g_c.numel(),
                           loss=abs(loss_c - loss_h),
                           global_=(g_c - g_h).abs().max().item())
        require(math.isfinite(loss_c) and worst[arch]["loss"] <= 1e-4
                and worst[arch]["global_"] <= 1e-4,
                f"{arch}: card round against the CPU's {worst[arch]}")
    emit(dict(phase="lm_train_small", card=smi, max_abs_err=worst,
              tol=1e-4))


def lm_train_paths(torch, np, model, engine, federated, availability, prng,
                   ops, ref, train, get_config, reduced, counts, smi):
    """Phase 3l: full-parameter federated LM training.  Returns the
    kernels-line record of K1 at the LM stack."""
    t0 = time.perf_counter()
    lm_train_cli_path(torch, train, counts, smi)
    rec = lm_full_width_path(torch, np, model, engine, federated,
                             availability, prng, ops, ref, get_config,
                             counts, smi)
    lm_small_paths(torch, np, model, engine, availability, prng, get_config,
                   reduced, counts, smi)
    emit(dict(phase="lm_train_paths_done", card=smi,
              seconds=time.perf_counter() - t0))
    return rec


# ---------------------------------------------------------------------------
# phase 3m: LoRA at full width, gemma3-27b: serving with its adapters (K4
# at head dim 128 with G = 2, windowed and global) and training them over
# the frozen base (K1 on the [4, N] LoRA stack)
# ---------------------------------------------------------------------------

LORA_ARCH = "gemma3-27b"
#: gemma3-27b's attention at the serving prefill (B 2, 32 query over 16
#: kv heads of 128, L = S = 8192, no soft-cap): windowed (1 024) and
#: global; its 62 layers: 52 windowed, 10 global
LORA_WINDOW, LORA_LAYERS, LORA_WINDOWED = 1024, 62, 52
GEMMA3_ATTN = [(2, 32, 16, 8192, 8192, 128, LORA_WINDOW, 0.0, True),
               (2, 32, 16, 8192, 8192, 128, None, 0.0, True)]
#: the adapters' b_* (zero at init, where they change nothing) drawn from
#: a second seed at this scale; the last-token logits must then move by
#: more than LORA_MOVES from the same prefill with the adapters zeroed
LORA_B_SCALE, LORA_MOVES = 0.02, 1e-2
#: the training run: clients, local steps (the config's local_steps),
#: sequences per client and step, their length, rounds in the timed
#: chunk, sequences each client owns in the store.  The sequence is cut
#: from 2 048 tokens: there the first round ran out of the card's 80 GB
#: (79.0 GB allocated, 54.0 of them the base); at 1 024 its peak is 75.7
LORA_M, LORA_S, LORA_B, LORA_L, LORA_K = 4, 2, 1, 1024, 2
LORA_PER_CLIENT = 4
#: kernel-name substrings of the serving profile's parts
LORA_SERVE_PARTS = {"K4": ("flash_fwd",),
                    "cublas": ("nvjet", "gemm", "cutlass", "sm90_xmma")}


def flat_leaves(tree, prefix=()):
    """(path, leaf) of a nested dict's tensors, in sorted key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@contextlib.contextmanager
def windows_seen(layers, record):
    """Inside the block every flash-kernel call of the model's attention
    (``layers.flash_mha``) appends its ``window`` to ``record``."""
    orig = layers.flash_mha

    def seen(*a, **kw):
        record.append(kw.get("window"))
        return orig(*a, **kw)

    layers.flash_mha = seen
    try:
        yield
    finally:
        layers.flash_mha = orig


def draw_adapters(torch, lora, seed):
    """Every ``b_*`` leaf of the adapter tree drawn in place on the card:
    N(0, LORA_B_SCALE^2) from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for path, t in flat_leaves(lora):
        if path[-1].startswith("b_"):
            t.normal_(0.0, LORA_B_SCALE, generator=gen)


def leaf_sums(tree, step=1 << 26):
    """path -> float64 sum of each leaf, summed ``step`` elements at a
    time (no float64 copy of a whole 5.6 GB leaf)."""
    out = {}
    for path, t in flat_leaves(tree):
        flat = t.reshape(-1)
        out[path] = sum(flat[i:i + step].double().sum()
                        for i in range(0, flat.numel(), step)).item()
    return out


def lora_serving(torch, model, layers, cfg, params, counts, smi):
    """gemma3-27b's serving path with its adapters: the main path (every
    count at 0 just before: K4 62 times in the prefill, 52 of them
    windowed, never in decode), the last-token logits against the same
    prefill with the adapters zeroed (they must differ by more than
    LORA_MOVES), each layer's flash attention against the xla branch's on
    the same input (bfloat16, LM_TOL_BF16_LAYER), then prefill and decode
    ms with a profile by part.  Returns (launches, windows seen)."""
    tokens = lm_tokens(torch, cfg.vocab, seed=62)
    windows = []
    with windows_seen(layers, windows):
        launches, logits, cache = lm_main_path(
            torch, model, cfg, params, tokens, counts, LORA_LAYERS,
            "gemma3_main_path", card=smi,
            adapters=model.count_params(cfg, trainable_only=True))
    require(windows.count(LORA_WINDOW) == LORA_WINDOWED
            and windows.count(None) == LORA_LAYERS - LORA_WINDOWED,
            f"K4 windows {windows}")
    del cache
    zero = dict(params, lora=tree_map(lambda k, t: torch.zeros_like(t),
                                      params["lora"]))
    cache = model.init_cache(cfg, LM_B, LM_L + LM_NEW)
    base_logits, cache = model.prefill(zero, cfg, cache, tokens)
    moved = (logits.float() - base_logits.float()).abs().max().item()
    del zero, cache, base_logits
    require(moved > LORA_MOVES, f"the adapters moved the logits by {moved}")
    torch.cuda.empty_cache()
    bf = prefill_drift(torch, model, cfg, params, tokens, LM_L + LM_NEW)
    del bf["runs"]
    torch.cuda.empty_cache()
    emit(dict(phase="gemma3_flash_vs_xla_bf16", card=smi, dtype=cfg.dtype,
              batch=LM_B, prompt=LM_L, adapters_moved_logits=moved,
              tol_layer=LM_TOL_BF16_LAYER, **bf))
    require(max(bf["layers"]) <= LM_TOL_BF16_LAYER,
            f"gemma3 flash vs xla per layer (bf16): {bf['layers']}")
    time_serve(torch, model, cfg, params, tokens, smi, "gemma3",
               LORA_SERVE_PARTS)
    return launches, windows


def lora_training(torch, np, model, engine, federated, availability, prng,
                  cfg, params, counts, smi):
    """gemma3-27b's adapters trained by FedAWE over its frozen base, on
    the flat [LORA_M, N] float32 state with K1, built from the engine with
    the base a runtime argument (``make_round_fn_with_frozen``,
    ``make_chunk_fn(..., with_frozen=True)``): m 4 at p 0.8, s 2, eta_l
    0.01, one sequence of LORA_L synthetic tokens (numpy, uniform over the
    vocabulary) per client and step.  Round 1 alone: every adapter leaf
    of the global moves, and each base leaf's float64 sum is bit-equal
    after it, no base leaf requiring a gradient.  Then LORA_K rounds in
    one chunk between CUDA events with every count at 0 just before (K1
    once a round, K2-K5 never), its peak allocated memory, one profiled
    round; every loss finite.  Returns (N, the chunk's launches)."""
    m, s, b, L = LORA_M, LORA_S, LORA_B, LORA_L
    trainable, frozen = model.split_trainable(params, cfg)
    n = model.count_params(cfg, trainable_only=True)
    fl = engine.FLConfig(m=m, s=s, eta_l=0.01, eta_g=1.0, strategy="fedawe",
                         lr_schedule=False, grad_clip=0.0, flat_state=True,
                         use_kernel=True)
    state = engine.init_fl_state(prng.PRNGKey(63, "cuda"), fl, trainable)
    require(state.spec.size == n, f"LoRA stack width {state.spec.size}")
    del trainable
    round_fn = engine.make_round_fn_with_frozen(
        fl, model.lm_loss_fn(cfg),
        availability.AvailabilityCfg(kind="stationary"),
        torch.full((m,), 0.8, device="cuda"))
    toks = np.random.default_rng(64).integers(
        0, cfg.vocab, (m * LORA_PER_CLIENT, L + 1)).astype(np.int32)
    store = federated.device_store(
        dict(tokens=toks[:, :-1], labels=toks[:, 1:]), None, "cuda",
        padded=federated.contiguous_client_index(m, LORA_PER_CLIENT))
    init, sample = federated.make_device_sampler(m, s, b,
                                                 min_count=LORA_PER_CLIENT)
    key = prng.PRNGKey(65, "cuda")
    ss = init(store, key)
    sums = leaf_sums(frozen)
    g0 = state.global_tr.clone()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        one = engine.make_chunk_fn(None, round_fn, sample, 1,
                                   with_frozen=True)
        torch.cuda.reset_peak_memory_stats()
        counts.reset()
        state, ss, met1 = one(state, frozen, ss, store, key)
        torch.cuda.synchronize()
        first = counts.read()
        peak1 = torch.cuda.max_memory_allocated()
        require(first == dict(K1=1, K2=0, K3=0, K4=0, K5=0),
                f"LoRA round 1 launches {first}")
        spec, g1 = state.spec, state.global_tr
        still = ["/".join(p) for p, o, k in zip(spec.paths, spec.offsets,
                                                spec.sizes)
                 if torch.equal(g0[o:o + k], g1[o:o + k])]
        require(not still, f"adapters that did not move in round 1: {still}")
        del g0, g1
        after = leaf_sums(frozen)
        changed = [p for p in sums if after[p] != sums[p]]
        require(not changed, f"base leaves changed by round 1: {changed}")
        grads = [p for p, t in flat_leaves(frozen) if t.requires_grad]
        require(not grads, f"base leaves requiring a gradient: {grads}")
        chunk = engine.make_chunk_fn(None, round_fn, sample, LORA_K,
                                     with_frozen=True)
        torch.cuda.reset_peak_memory_stats()
        counts.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, ss, met = chunk(state, frozen, ss, store, key)
        end.record()
        end.synchronize()
        launches = counts.read()
        round_ms = start.elapsed_time(end) / LORA_K
        peak = torch.cuda.max_memory_allocated()
        require(launches == dict(K1=LORA_K, K2=0, K3=0, K4=0, K5=0),
                f"LoRA chunk launches {launches}")
        losses = [met1["loss"].item()] + met["loss"].tolist()
        require(all(math.isfinite(v) for v in losses), f"losses {losses}")
        require(bool(torch.isfinite(state.global_tr).all()),
                "LoRA global not finite")
        box = {}

        def profiled():
            box["out"] = one(state, frozen, ss, store, key)

        prof = profile_ms(torch, profiled, parts=LM_TRAIN_PARTS)
        if prof["device_ms"]:
            prof["parts_ms"]["rest"] = (prof["device_ms"]
                                        - sum(prof["parts_ms"].values()))
        losses.append(box["out"][2]["loss"].item())
        require(math.isfinite(losses[-1]), f"profiled loss {losses[-1]}")
        perf_drops = sorted({str(w.message)[:120] for w in caught
                             if "performance drop" in str(w.message)})
    emit(dict(phase="gemma3_lora_train", card=smi, arch=cfg.name,
              dtype=cfg.dtype, remat=cfg.remat,
              remat_policy=cfg.remat_policy, adapters=n,
              base_gb=tree_bytes(frozen) / 1e9, m=m, s=s, batch=b, seq=L,
              rounds=LORA_K, launches=launches, round_ms=round_ms,
              peak_allocated_gb=peak / 1e9,
              round1_peak_allocated_gb=peak1 / 1e9,
              state_gb=(m + 2) * n * 4 / 1e9, losses=losses,
              n_active=[met1["n_active"].item()] + met["n_active"].tolist(),
              base_leaves_unchanged=len(sums),
              profiled_round=dict(
                  prof, busy_share=(prof["device_ms"] / round_ms
                                    if prof["device_ms"] else None)),
              vmap_fallbacks=perf_drops))
    model_flops_share(cfg, m * s * b * L, "train", round_ms, smi,
                      "gemma3_lora_round")
    del state, ss, box, chunk, one, store
    return n, launches


def lora_paths(torch, np, model, layers, engine, federated, availability,
               prng, ops, ref, get_config, counts, smi):
    """Phase 3m: gemma3-27b at its published widths and depth (62 layers,
    d_model 5 376, 32 query over 16 kv heads of 128, 1 024-token windows
    on 52 layers, vocab 262 144 tied, logit soft-cap 30; 27.04 B
    parameters, 33.5 M of them rank-16 adapters) in bfloat16 with
    attn_backend="flash": one base from a seed with ``init_params``, the
    adapters' ``b_*`` from a second; ``lora_serving``, then
    ``lora_training`` on the same weights; the weights freed, K1 alone at
    the [LORA_M, N] float32 stack against its plain version (1e-5), timed
    beside it and its bound.  Returns the serving path's K4 launches and
    windows, and the kernels-line record of K1 at the LoRA stack."""
    t0 = time.perf_counter()
    cfg = full_config(get_config, LORA_ARCH, "bfloat16")
    require(cfg.fl_mode == "lora", f"{cfg.name} fl_mode {cfg.fl_mode}")
    params = lm_weights(torch, model, cfg, seed=60)
    draw_adapters(torch, params["lora"], seed=61)
    torch.cuda.synchronize()
    emit(dict(phase="gemma3_weights", card=smi, params=model.count_params(cfg),
              adapters=model.count_params(cfg, trainable_only=True),
              weights_gb=tree_bytes(params) / 1e9,
              allocated_gb=torch.cuda.memory_allocated() / 1e9,
              seconds=time.perf_counter() - t0))
    serve_launches, windows = lora_serving(torch, model, layers, cfg, params,
                                           counts, smi)
    n, train_launches = lora_training(torch, np, model, engine, federated,
                                      availability, prng, cfg, params,
                                      counts, smi)
    del params
    torch.cuda.empty_cache()
    rec = lm_k1_at_stack(torch, ops, ref, n, smi, m=LORA_M)
    rec["launches"] = train_launches["K1"]
    emit(dict(phase="lora_paths_done", card=smi,
              seconds=time.perf_counter() - t0))
    return dict(k4=serve_launches["K4"], windows=windows, k1=rec)


def time_flash_gemma3(torch, fops, fref, smi):
    """K4 (bf16) at gemma3-27b's two attention shapes: the kernel over 20
    calls, the plain version (a batch row at a time, ``plain_flash``)
    over 2, and the library call over 20: SDPA (``is_causal``,
    ``enable_gqa``: the same function) at the global shape, compiled
    flex_attention with the causal sliding-window block mask at the
    windowed one, with its error against the plain version; the bound in
    tensor-core flops and the flops the kernel's tiles issue."""
    out = {}
    for case in GEMMA3_ATTN:
        tag = "windowed" if case[6] else "global"
        q, k, v = flash_inputs(torch, case, torch.bfloat16, seed=720)
        kw = flash_kw(case)
        k_ms = events_ms(torch, lambda: fops.flash_mha(q, k, v, **kw), 20)
        plain = plain_flash(fref, q, k, v, case)
        p_ms = events_ms(torch, lambda: plain_flash(fref, q, k, v, case), 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t0 = time.perf_counter()
        if case[6]:
            lib = flex_call(torch, qt, kt, vt, case[6], case[7])
            name = "torch flex_attention (compiled, sliding-window mask)"
        else:
            def lib():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            name = "torch scaled_dot_product_attention (is_causal, enable_gqa)"
        lib_err = (lib().transpose(1, 2).float()
                   - plain.float()).abs().max().item()
        first_s = time.perf_counter() - t0
        l_ms = events_ms(torch, lib, 20)
        del plain
        b_ms, b_by, flops = flash_bound(case, 2, BF16_FLOP_PER_S)
        issued = flash_issued_flops(case, FLASH_BM, FLASH_BN,
                                    flash_product_dims(case[5]))
        out[tag] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                        library=name, library_max_abs_err=lib_err,
                        library_first_call_s=first_s, bound_ms=b_ms,
                        bound_by=b_by, flops=flops,
                        tflop_per_s=flops / k_ms / 1e9,
                        share_of_bound=b_ms / k_ms, vs_library=k_ms / l_ms,
                        issued_flops=issued,
                        issued_tflop_per_s=issued / k_ms / 1e9)
        emit(dict(phase="kernel_time", card=smi, kernel="K4",
                  arch=LORA_ARCH, shape=case[:6], window=case[6],
                  dtype="bfloat16", **out[tag]))
        del q, k, v, qt, kt, vt, lib
        torch.cuda.empty_cache()
    torch.compiler.reset()
    return out


# ---------------------------------------------------------------------------
# phase 3n: the examples, the seed mesh and the kernel-library cache
# ---------------------------------------------------------------------------
# K1 / K2's partial form (phase 2, phase 4) and the placed FL path (3o)
# ---------------------------------------------------------------------------

#: the LM training stack of phase 3l: mamba2-130m's flat trainables
LM_STACK_N = 128983488
#: K1 / K2's partial form against the fused K1 and its plain version, in
#: float32 and bfloat16 alike
PARTIAL_TOL = 1e-5
#: K1 / K2's partial form, (variant, m, N, dtype name, row-block bounds,
#: block whose mask is all zero or None, seeds): ECHO_CASES' shapes cut
#: into two and three row blocks (one block empty, one with an all-zero
#: mask), the main path's stacks on the seed axis, and the LM stack in two
#: blocks of 4 (8.3 GB of float32)
PARTIAL_CASES = [
    ("K1", M_MAIN, N_MAIN, "float32", (0, 50, 100), None, 0),
    ("K2", M_MAIN, N_MAIN, "float32", (0, 0, 40, 100), 1, 0),
    ("K1", M_MAIN, N_MAIN, "bfloat16", (0, 33, 66, 100), 0, 0),
    ("K2", M_MAIN, N_MAIN, "bfloat16", (0, 50, 50, 100), None, 0),
    ("K1", 37, 3 * 256 + 5, "float32", (0, 0, 20, 37), 2, 0),
    ("K2", 64, 4099, "bfloat16", (0, 32, 64), 1, 0),
    ("K1", 16, 1000, "float32", (0, 8, 16), 0, 0),
    ("K1", 1, N_MAIN, "float32", (0, 0, 1), None, 0),
    ("K1", COHORT_C, N_MAIN, "float32", (0, 128, 256), None, 0),
    ("K1", M_MAIN, N_MAIN, "float32", (0, 50, 100), None, 4),
    ("K2", M_MAIN, N_MAIN, "bfloat16", (0, 0, 50, 100), 1, 4),
    ("K1", 8, LM_STACK_N, "float32", (0, 4, 8), None, 0),
]


def partial_launches(ops):
    return dict(partial=ops.echo_aggregate_partial.launches,
                partial_upload=ops.echo_aggregate_partial.upload_launches,
                finalize=ops.echo_aggregate_finalize.launches)


def call_partial(fn, a, lo, hi, upload):
    """``fn`` (the kernel's wrapper or its plain version) on rows
    ``[lo, hi)`` of ``a``'s stacks (the client axis is the one before
    the columns)."""
    rows = slice(lo, hi)

    def cut(t):
        return None if t is None else t[..., rows].contiguous()

    return fn(a["x"][..., rows, :].contiguous(),
              a["y"][..., rows, :].contiguous(), cut(a["mask"]),
              cut(a["echo"]), ETA_G, upload=cut(a["upload"]) if upload
              else None)


def check_partial(torch, ops, ref):
    """K1 / K2's partial form and its finalize: per case, the partials of
    the row blocks summed in block order and finalized, against the fused
    K1 on the whole stack within PARTIAL_TOL in float32 and bfloat16 alike
    (both forms widen a bfloat16 stack to float32 before any arithmetic),
    each block's partial against its plain version within PARTIAL_TOL of
    the partial's largest value (sums of up to m terms that may cancel;
    the absolute error is reported beside it), and the finalize bit-equal
    to its plain version; one counted launch of the partial per non-empty
    block and of the finalize per case, none of the fused kernel.
    Returns, at the placed path's shapes ([M_MAIN, N] float32), the
    largest absolute errors against the plain versions per form, and the
    partials' largest error against their largest value."""
    errs = {"K1 partial": 0.0, "K2 partial": 0.0, "finalize": 0.0,
            "K1 partial, of the largest": 0.0,
            "K2 partial, of the largest": 0.0}
    for i, (variant, m, n, dname, bounds, zero, S) in enumerate(
            PARTIAL_CASES):
        dtype = getattr(torch, dname)
        up = variant == "K2"
        a = (seed_inputs(torch, S, m, n, dtype, 300 + i, up) if S
             else make_inputs(torch, m, n, dtype, seed=300 + i, upload=up))
        blocks = list(zip(bounds[:-1], bounds[1:]))
        if zero is not None:
            a["mask"][..., blocks[zero][0]:blocks[zero][1]] = 0.0
        fused = call_kernel(ops, variant, a)
        torch.cuda.synchronize()
        before = (launch_count(ops, variant), partial_launches(ops))
        tol = PARTIAL_TOL
        total = plain_total = None
        part_err = part_abs = 0.0
        for lo, hi in blocks:
            p = call_partial(ops.echo_aggregate_partial, a, lo, hi, up)
            q = call_partial(ref.echo_aggregate_partial_ref, a, lo, hi, up)
            # sums of up to m terms that cancel: each seed's partial's
            # error against its own largest value (at least 1)
            diff = (p - q).abs().amax(dim=-1)
            err = (diff / q.abs().amax(dim=-1).clamp(min=1.0)).max().item()
            require(err <= tol,
                    f"partial {variant} rows [{lo}, {hi}) of ({m}, {n}, "
                    f"{dname}, S={S}) against its plain version: {err}")
            part_err = max(part_err, err)
            part_abs = max(part_abs, diff.max().item())
            total = p if total is None else total + p
            plain_total = q if plain_total is None else plain_total + q
        out = ops.echo_aggregate_finalize(total, a["g"])
        plain = ref.echo_aggregate_finalize_ref(total, a["g"])
        whole = ref.echo_aggregate_finalize_ref(plain_total, a["g"])
        torch.cuda.synchronize()
        after = (launch_count(ops, variant), partial_launches(ops))
        nonempty = sum(hi > lo for lo, hi in blocks)
        key = "partial_upload" if up else "partial"
        counted = {k: after[1][k] - before[1][k] for k in after[1]}
        fin_err = (out - plain).abs().max().item()
        fused_err = (out - fused).abs().max().item()
        expect = dict(partial=0, partial_upload=0, finalize=1)
        expect[key] = nonempty
        ok = (after[0] == before[0] and counted == expect
              and torch.equal(out, plain)
              and torch.allclose(out, fused, rtol=tol, atol=tol)
              and torch.allclose(whole, fused, rtol=tol, atol=tol)
              and bool(torch.isfinite(out).all()))
        emit(dict(phase="kernel_check", kernel=f"{variant} partial", m=m,
                  n=n, dtype=dname, seeds=S, blocks=blocks,
                  zero_mask_block=zero, launches=counted,
                  partial_vs_plain_abs=part_abs,
                  partial_vs_plain_of_largest=part_err,
                  finalize_vs_plain=fin_err, vs_fused=fused_err, tol=tol,
                  ok=ok))
        require(ok, f"partial form {variant} at ({m}, {n}, {dname}, "
                    f"S={S}) disagrees with the fused kernel or its plain "
                    "version")
        if (m, n, dname, S) == (M_MAIN, N_MAIN, "float32", 0):
            for k, e in ((f"{variant} partial", part_abs),
                         (f"{variant} partial, of the largest", part_err),
                         ("finalize", fin_err)):
                errs[k] = max(errs[k], e)
        del a, fused, total, plain_total, out, plain, whole
    torch.cuda.empty_cache()
    return errs


def partial_bound(m, n, upload, seeds=1):
    """Least time in ms of the partial form: x and y read once (float32),
    the [m] vectors read, the [N + 1] partials written, about 5 float32
    operations per (client, column) element."""
    nbytes = seeds * (2 * m * n * 4 + 4 * m * (3 if upload else 2)
                      + (n + 1) * 4)
    flops = 5 * seeds * m * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def time_partial(torch, ops, ref, smi):
    """The partial form at a placed rank's rows of the FL path ([50, N]
    float32, K1 and K2) and at the LM stack's two blocks ([4, 128 983
    488]), and the finalize at N: device time per call (``graph_ms``,
    CUDA graphs of calls over operand sets rotating through more than
    the 50 MB L2; one set at the LM stack, 2.1 GB a call), the kernel and
    its plain version in turns, beside the bound."""
    out = {}
    cases = [("K1 partial", 50, N_MAIN, False, 8, 64),
             ("K2 partial", 50, N_MAIN, True, 8, 64),
             ("K1 partial, LM stack", 4, LM_STACK_N, False, 1, 2)]
    for name, m, n, up, n_sets, n_calls in cases:
        sets = [make_inputs(torch, m, n, torch.float32, seed=77 + j,
                            upload=up) for j in range(n_sets)]

        def kern(i):
            return call_partial(ops.echo_aggregate_partial,
                                sets[i % n_sets], 0, m, up)

        def plain(i):
            return call_partial(ref.echo_aggregate_partial_ref,
                                sets[i % n_sets], 0, m, up)
        t = [graph_ms(torch, f, n_calls) for f in (kern, plain, plain, kern)]
        b_ms, b_by, nbytes = partial_bound(m, n, up)
        out[name] = dict(ms=(t[0] + t[3]) / 2, turns_ms=[t[0], t[3]],
                         plain_ms=(t[1] + t[2]) / 2, bound_ms=b_ms,
                         bound_by=b_by)
        emit(dict(phase="kernel_time", card=smi, kernel=name, m=m, n=n,
                  bytes=nbytes, share=b_ms / out[name]["ms"],
                  **out[name]))
        del sets
    parts = [torch.randn(N_MAIN + 1, device="cuda") for _ in range(8)]
    for q in parts:
        q[-1] = 3.0
    g = [torch.randn(N_MAIN, device="cuda") for _ in range(8)]
    t = [graph_ms(torch, f, 64) for f in (
        lambda i: ops.echo_aggregate_finalize(parts[i % 8], g[i % 8]),
        lambda i: ref.echo_aggregate_finalize_ref(parts[i % 8], g[i % 8]),
        lambda i: ref.echo_aggregate_finalize_ref(parts[i % 8], g[i % 8]),
        lambda i: ops.echo_aggregate_finalize(parts[i % 8], g[i % 8]))]
    nbytes = (3 * N_MAIN + 1) * 4   # the partials and g read, out written
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * N_MAIN / FP32_FLOP_PER_S
    out["finalize"] = dict(ms=(t[0] + t[3]) / 2, turns_ms=[t[0], t[3]],
                           plain_ms=(t[1] + t[2]) / 2,
                           bound_ms=1e3 * max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations")
    emit(dict(phase="kernel_time", card=smi, kernel="finalize", n=N_MAIN,
              bytes=nbytes, share=out["finalize"]["bound_ms"]
              / out["finalize"]["ms"], **out["finalize"]))
    torch.cuda.empty_cache()
    return out


#: phase 3o: two seeds over a (2, 1, 2) ('seed', 'pod', 'data') mesh of
#: four ranks on one card, each rank 50 clients of one seed
PLACED_SEEDS, PLACED_RANKS, PLACED_ROUNDS, PLACED_K = 2, 4, 16, 8
PLACED_CELLS = (("sine", "fedawe/sine"),
                ("fault", "fedawe/stale_d2+midround"))
#: globals, client stacks and losses: the placed sums add the ranks'
#: partials in another order than one launch over all rows
PLACED_TOL = 1e-5
#: the spawned ranks' whole phase, setup included
PLACED_TIMEOUT_S = 300


def placed_run(torch, experiments, prng, mesh_or_none, name):
    """One cell of phase 3o through ``run_multi_seed`` as ``run_scenario``
    drives it: unplaced (``mesh_or_none`` None) or as this rank's part of
    the mesh (its round built for its client block), on the current
    card."""
    dev = torch.device("cuda", torch.cuda.current_device())
    sc = experiments.get_scenario(name)
    pl = (None if mesh_or_none is None else
          experiments.seed_chunk_placement(mesh_or_none, M_MAIN,
                                           PLACED_SEEDS))
    fl, rf, params, ds, eval_fn, _, fault, stale = experiments._cell_task(
        sc, preset="image", seed=0, use_kernel=True, rounds=PLACED_ROUNDS,
        device=dev, place=None if pl is None else pl.clients, **SEED_TASK)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop")
        states, hists, finals = experiments.run_multi_seed(
            fl, rf, params, ds, sampling=sc.sampling,
            batch=SEED_TASK["batch"], seeds=PLACED_SEEDS,
            rounds=PLACED_ROUNDS, chunk_rounds=PLACED_K,
            rng=prng.PRNGKey(0, dev), data_key=prng.PRNGKey(1, dev),
            eval_fn=eval_fn, mesh=pl, fault=fault, stale=stale)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    held = None
    if pl is not None:
        # what the rank holds, then the whole state gathered for the gates
        held = dict(clients_tr=tuple(states.local.clients_tr.shape),
                    state_bytes=leaf_bytes(torch, states.local))
        states = experiments.join_seed_shards(states)
    return dict(states=states, hists=hists, finals=finals, wall_s=wall,
                peak_bytes=peak, held=held,
                state_bytes=leaf_bytes(torch, states))


def leaf_bytes(torch, tree):
    """Bytes of the tensor leaves of ``tree``."""
    import torch.utils._pytree as pytree

    return sum(v.numel() * v.element_size() for v in pytree.tree_leaves(tree)
               if torch.is_tensor(v))


def placed_rank(rank, store_path, out_dir):
    """One rank of phase 3o, spawned: joins a gloo group through a
    ``FileStore`` (NCCL refuses two ranks on one card, and the four ranks
    share card 0), builds the ``(2, 1, 2)`` seed mesh, and runs the two
    cells (the first three times: two timing turns, then one whose
    collectives rank 0 counts for phase 3p), counting every K1 form's
    launches from 0 just before each run.  Writes its counts and
    times, and rank 0 the gathered results, under ``out_dir``."""
    import faulthandler

    import torch
    import torch.distributed as dist

    from repro_torch.core import prng
    from repro_torch.kernels.echo_aggregate import ops
    from repro_torch.launch import analysis, experiments, mesh

    faulthandler.enable()      # a crash in native code prints its stack
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                         PLACED_RANKS),
                            rank=rank, world_size=PLACED_RANKS)
    try:
        m = mesh.make_seed_mesh(PLACED_SEEDS, device_type="cuda")
        out = dict(mesh=mesh.mesh_axis_sizes(m), runs={})
        for tag, name in PLACED_CELLS + (("sine_again", "fedawe/sine"),
                                         ("sine_counted", "fedawe/sine")):
            ops.echo_aggregate_flat.launches = 0
            ops.echo_aggregate_flat.upload_launches = 0
            ops.echo_aggregate_partial.launches = 0
            ops.echo_aggregate_partial.upload_launches = 0
            ops.echo_aggregate_finalize.launches = 0
            if rank == 0 and tag == "sine_counted":
                # phase 3p: the round's collectives, counted on rank 0 in
                # a run of its own (the counter slows it: not a timing
                # turn)
                with analysis.CollectiveCounter() as counter:
                    r = placed_run(torch, experiments, prng, m, name)
                r["collectives"] = dict(
                    counter.collective_bytes(),
                    calls_by_op=dict(counter.calls_by_op),
                    bytes_by_op=dict(counter.bytes_by_op),
                    top=counter.collective_top())
            else:
                r = placed_run(torch, experiments, prng, m, name)
            r["launches"] = dict(
                fused=ops.echo_aggregate_flat.launches,
                fused_upload=ops.echo_aggregate_flat.upload_launches,
                **partial_launches(ops))
            if rank != 0:
                r = {k: r[k] for k in ("launches", "wall_s", "peak_bytes",
                                       "held")}
            out["runs"][tag] = r
        # phase 3q (a) on the same ranks
        out["tree"] = tree_placed_rank(torch, rank)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(torch, fn, nprocs, args, timeout_s):
    """``fn(rank, *args)`` in ``nprocs`` spawned processes, joined within
    ``timeout_s``: a rank that raises, or a hung collective past the
    limit, kills the others and fails the phase."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after "
                                     f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def placed_fl_path(torch, experiments, prng, ops, counts, smi):
    """Phase 3o: fedawe/sine and fedawe/stale_d2+midround at the FL path's
    size (m 100, s 5, batch 32, the full-width CNN), 2 seeds, 16 rounds
    in chunks of 8, with the kernel: unplaced in this process (the fused
    K1 / K2 once a round for both seeds), then over four spawned ranks on
    card 0 (``placed_rank``), each holding 50 clients of one seed, then
    unplaced again (the timing turns: unplaced, placed, placed,
    unplaced).  Gates: each rank's partial form once a round (K2's under
    the fault cell), the finalize once a round, the fused kernel never;
    the placed run's histories' counts (n_active, mean_echo and the fault
    cell's n_dropped, n_rejected, n_stale, mean_staleness), τ, keys, t,
    markov and ring ages bit-equal to the unplaced run's, losses, globals
    and client stacks within PLACED_TOL, final evals within 2 of 1 024."""
    import tempfile

    unplaced = {}
    for tag, name in PLACED_CELLS:
        counts.reset()
        unplaced[tag] = placed_run(torch, experiments, prng, None, name)
        unplaced[tag]["launches"] = counts.read()
    require(unplaced["sine"]["launches"]["K1"] == PLACED_ROUNDS
            and unplaced["fault"]["launches"]["K2"] == PLACED_ROUNDS,
            f"unplaced launches {[unplaced[t]['launches'] for t in unplaced]}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn_ranks(torch, placed_rank, PLACED_RANKS,
                    (os.path.join(tmp, "store"), tmp), PLACED_TIMEOUT_S)
        spawned_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False)
                 for r in range(PLACED_RANKS)]
    again = placed_run(torch, experiments, prng, None, "fedawe/sine")
    require(ranks[0]["mesh"] == {"seed": 2, "pod": 1, "data": 2},
            f"placed mesh {ranks[0]['mesh']}")
    want = dict(sine=dict(fused=0, fused_upload=0, partial=PLACED_ROUNDS,
                          partial_upload=0, finalize=PLACED_ROUNDS),
                fault=dict(fused=0, fused_upload=0, partial=0,
                           partial_upload=PLACED_ROUNDS,
                           finalize=PLACED_ROUNDS))
    want["sine_again"] = want["sine_counted"] = want["sine"]
    held = (PLACED_SEEDS // 2, M_MAIN // 2, N_MAIN)
    for r, rk in enumerate(ranks):
        for tag, w in want.items():
            require(rk["runs"][tag]["launches"] == w,
                    f"rank {r} {tag} launches {rk['runs'][tag]['launches']}")
            require(rk["runs"][tag]["held"]["clients_tr"] == held,
                    f"rank {r} {tag} holds {rk['runs'][tag]['held']}")
    exact = ("n_active", "mean_echo", "t", "n_dropped", "n_rejected",
             "n_stale", "mean_staleness")
    diffs = {}
    for tag, _ in PLACED_CELLS:
        a, b = ranks[0]["runs"][tag], unplaced[tag]
        loss_diff = 0.0
        for ha, hb in zip(a["hists"], b["hists"]):
            require(len(ha) == len(hb) == PLACED_ROUNDS, "placed history")
            for ra, rb in zip(ha, hb):
                require(set(ra) == set(rb), f"metric keys {set(ra)}")
                require(all(ra[k] == rb[k] for k in exact if k in ra),
                        f"placed {tag} counts differ: {ra} {rb}")
                require(math.isfinite(ra["loss"]), f"loss {ra['loss']}")
                loss_diff = max(loss_diff, abs(ra["loss"] - rb["loss"]))
        sa, sb = a["states"], b["states"]
        for name in ("tau", "rng", "t", "markov"):
            require(torch.equal(getattr(sa, name).cpu(),
                                getattr(sb, name).cpu()),
                    f"placed {tag} {name} differs from the unplaced run")
        if sb.stale is not None:
            require(torch.equal(sa.stale["ages"].cpu(),
                                sb.stale["ages"].cpu()),
                    f"placed {tag} ring ages differ")
        state_diff = max((getattr(sa, k).cpu() - getattr(sb, k).cpu())
                         .abs().max().item()
                         for k in ("global_tr", "clients_tr"))
        eval_diff = max(abs(fa["eval_acc"] - fb["eval_acc"])
                        for fa, fb in zip(a["finals"], b["finals"]))
        require(loss_diff <= PLACED_TOL and state_diff <= PLACED_TOL,
                f"placed {tag}: losses {loss_diff}, states {state_diff}")
        require(eval_diff <= 2 / 1024, f"placed {tag} evals {eval_diff}")
        diffs[tag] = dict(max_loss_diff=loss_diff,
                          max_state_diff=state_diff,
                          max_eval_diff=eval_diff)
    placed_s = [max(rk["runs"][t]["wall_s"] for rk in ranks)
                for t in ("sine", "sine_again")]
    unplaced_s = [unplaced["sine"]["wall_s"], again["wall_s"]]
    emit(dict(phase="placed_fl_path", card=smi, seeds=PLACED_SEEDS,
              ranks=PLACED_RANKS, mesh=ranks[0]["mesh"], m=M_MAIN,
              rows_per_rank=M_MAIN // 2, rounds=PLACED_ROUNDS,
              chunk_rounds=PLACED_K, backend="gloo",
              launches_per_rank={t: ranks[0]["runs"][t]["launches"]
                                 for t in want},
              unplaced_launches={t: unplaced[t]["launches"]
                                 for t in unplaced},
              placed_wall_s_turns=placed_s, unplaced_wall_s_turns=unplaced_s,
              counted_run_wall_s=max(rk["runs"]["sine_counted"]["wall_s"]
                                     for rk in ranks),
              placed_wall_s=sum(placed_s) / 2,
              unplaced_wall_s=sum(unplaced_s) / 2,
              rank_state_bytes={t: [rk["runs"][t]["held"]["state_bytes"]
                                    for rk in ranks] for t in want},
              unplaced_state_bytes={t: unplaced[t]["state_bytes"]
                                    for t in unplaced},
              rank_peak_bytes={t: [rk["runs"][t]["peak_bytes"]
                                   for rk in ranks] for t in want},
              unplaced_peak_bytes={t: unplaced[t]["peak_bytes"]
                                   for t in unplaced},
              spawned_s=spawned_s, tol=PLACED_TOL, **diffs))
    return dict(ranks=ranks,
                collectives=ranks[0]["runs"]["sine_counted"]["collectives"],
                partial=ranks[0]["runs"]["sine"]["launches"]["partial"],
                partial_upload=ranks[0]["runs"]["fault"]["launches"]
                ["partial_upload"],
                finalize=sum(ranks[0]["runs"][t]["launches"]["finalize"]
                             for t, _ in PLACED_CELLS))


# ---------------------------------------------------------------------------
# phase 3p: the dry run's counters against real runs on the card

#: the fake prefill's counted temp peak over the card's allocated peak
#: above the arguments (read equal to the byte on an H100 in every run,
#: 1 510 014 976 bytes: each allocation of the step is an operator's
#: result)
TEMP_RATIO = (0.98, 1.02)
#: a placed round's metric sums, stacked into its second all-reduce
#: (mu, loss, n_active, echo)
PLACED_ROUND_SUMS = 4


def lowering_prefill(torch, model, analysis, get_config, counts, smi):
    """Phase 3p (a): gemma2-2b's prefill at its published widths
    (bfloat16, K4, B ``LM_B``, prompt and cache ``LM_L``) once on the
    card under ``analysis.CollectiveCounter``, then the same step over
    fake CUDA tensors (``FakeTensorMode``: no card memory, no kernel), as
    the dry run runs its steps.  Gates: the counted flops and bytes
    accessed equal; K4 ``LM_LAYERS`` times in the real run, no launch in
    the fake one; no collective in either; the fake run's counted temp
    peak within ``TEMP_RATIO`` of ``torch.cuda.max_memory_allocated``
    above the arguments in the real one."""
    import torch.utils._pytree as pytree
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = lm_config(get_config, "bfloat16")
    params = lm_weights(torch, model, cfg, seed=4)
    tokens = lm_tokens(torch, cfg.vocab, seed=5)
    args = (params, model.init_cache(cfg, LM_B, LM_L), tokens)

    def step(params, cache, tokens):
        return model.prefill(params, cfg, cache, tokens)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    t0 = time.perf_counter()
    with analysis.CollectiveCounter() as real:
        out = step(*args)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    real_launches = counts.read()
    require(bool(torch.isfinite(out[0]).all()), "3p: non-finite logits")
    real_mem = analysis.memory_numbers(real, args, out)
    del out
    mode = FakeTensorMode()
    fake_args = pytree.tree_map(
        lambda v: mode.from_tensor(v) if torch.is_tensor(v) else v, args)
    held = torch.cuda.memory_allocated()
    counts.reset()
    t0 = time.perf_counter()
    with mode, analysis.CollectiveCounter() as fake:
        fake_out = step(*fake_args)
    fake_s = time.perf_counter() - t0
    fake_launches = counts.read()
    fake_mem = analysis.memory_numbers(fake, fake_args, fake_out)
    require(torch.cuda.memory_allocated() == held,
            "3p: the fake prefill allocated card memory")
    require(real_launches == dict(K1=0, K2=0, K3=0, K4=LM_LAYERS, K5=0),
            f"3p real prefill launches {real_launches}")
    require(not any(fake_launches.values()),
            f"3p fake prefill launched {fake_launches}")
    real_cost, fake_cost = (analysis.cost_numbers(c) for c in (real, fake))
    require(real_cost == fake_cost,
            f"3p counts differ: real {real_cost}, fake {fake_cost}")
    require(real.calls == fake.calls == 0,
            f"3p collectives {real.calls}, {fake.calls}")
    ratio = fake.peak_bytes / peak
    require(TEMP_RATIO[0] <= ratio <= TEMP_RATIO[1],
            f"3p counted temp {fake.peak_bytes} against the card's {peak}")
    rec = dict(phase="lowering_prefill", card=smi, arch=cfg.name,
               dtype=cfg.dtype, batch=LM_B, prompt=LM_L,
               flops=real_cost["flops"],
               model_flops=analysis.model_flops(cfg, LM_B * LM_L,
                                                "inference"),
               bytes_accessed=real_cost["bytes accessed"],
               temp_counted_fake=fake.peak_bytes,
               temp_counted_real=real.peak_bytes,
               max_allocated_above_args=peak, temp_ratio=ratio,
               memory_real=real_mem, memory_fake=fake_mem,
               launches_real=real_launches, launches_fake=fake_launches,
               collectives=real.collective_bytes(), real_s=real_s,
               fake_s=fake_s)
    emit(rec)
    del params, args, fake_args, fake_out
    torch.cuda.empty_cache()
    return rec


def lowering_placed_round(placed, smi):
    """Phase 3p (b): rank 0's collectives in a third placed fedawe/sine
    run of phase 3o's ranks (counted there, after the timing turns): each
    round exactly two client
    all-reduces (``repro_torch::client_all_reduce``), of K1's partial form
    over the rank's seed rows, ``[S, N + 1]`` float32, and of the stacked
    metric sums, ``[PLACED_ROUND_SUMS, S]``."""
    c = placed["collectives"]
    op = "repro_torch::client_all_reduce"
    rows = PLACED_SEEDS // 2
    want = PLACED_ROUNDS * 4 * rows * (N_MAIN + 1 + PLACED_ROUND_SUMS)
    calls, nbytes = c["calls_by_op"].get(op, 0), c["bytes_by_op"].get(op, 0)
    require(calls == 2 * PLACED_ROUNDS and nbytes == want,
            f"3p placed round: {calls} client all-reduces of {nbytes} "
            f"bytes; want {2 * PLACED_ROUNDS} of {want}")
    emit(dict(phase="lowering_placed_round", card=smi, rounds=PLACED_ROUNDS,
              client_all_reduces=calls, client_all_reduce_bytes=nbytes,
              per_round=dict(calls=calls / PLACED_ROUNDS,
                             bytes=nbytes / PLACED_ROUNDS),
              collectives={k: v for k, v in c.items()
                           if k not in ("calls_by_op", "bytes_by_op")},
              calls_by_op=c["calls_by_op"]))


# ---------------------------------------------------------------------------
# phase 3q: the tree-state placed round, K1's partial form on each rank's
# column shards

#: phase 3q (a): ``tiny`` on tree state, float32, FedAWE with K1, m = 8
#: over a ('data', 'model') mesh of phase 3o's four ranks on card 0: (4,
#: 1), two client rows a rank.  On the (2, 2) mesh each leaf's model dims
#: would be split over two ranks, and DTensor's all-gathers over 'model'
#: of CUDA tensors through gloo segfaulted there (torch 2.11), as its
#: gathers did in phase 3o; ``tools/chip_probe_nccl.py --tree`` runs the
#: (2, 2) case over four cards under NCCL
TREE_PLACED_M, TREE_PLACED_ROUNDS = 8, 2
TREE_PLACED_MESH = (4, 1)
TREE_PLACED_B, TREE_PLACED_L = 2, 16
#: globals and client leaves against the unplaced tree round: the ranks'
#: partial sums and DTensor's reductions over 'model' add in another
#: order
TREE_PLACED_TOL = 1e-5
#: phase 3q (b): the dry run's tree step at the arch's published widths,
#: its depth cut to ``TREE_STEP_LAYERS`` (two of its 13 local/global
#: units): each full-depth run takes about 53 s of this host's CPU
#: (DTensor's and FakeTensor's dispatch), twice that for the pair; the
#: full depth's record is the CPU dry run's (``PERF.md``)
TREE_STEP_ARCH, TREE_STEP_LAYERS = "gemma2-2b", 4
#: the fake CUDA step's counted flops over the CPU record's.  Not 1 on
#: torch 2.11: DTensor picks a matmul's strategy by a redistribution cost
#: that depends on the mesh's device type, and under the CUDA mesh five
#: of the unit's projections run whole on a few more calls (1.038 at 4
#: layers, 1.056 at 2, read on an H100 host); the collective bytes are
#: equal
TREE_STEP_FLOPS_RATIO = (1.0, 1.1)
CARD_BYTES = 80e9


def tree_placed_inputs(torch, np, dev):
    """Phase 3q (a)'s inputs on ``dev``: ``tiny``'s weights from a seed
    (float32) and ``TREE_PLACED_ROUNDS`` token batches ``[m, s, B, L]``
    drawn with numpy."""
    from repro_torch.configs import get_config
    from repro_torch.models import model

    cfg = get_config("tiny")
    params = tree_map(lambda k, v: v.to(dev), model.init_params(
        torch.Generator().manual_seed(11), cfg))
    rng = np.random.default_rng(12)
    shape = (TREE_PLACED_M, cfg.local_steps, TREE_PLACED_B, TREE_PLACED_L)
    batches = []
    for _ in range(TREE_PLACED_ROUNDS):
        toks = rng.integers(0, cfg.vocab, shape)
        batches.append(dict(
            tokens=torch.from_numpy(toks.astype(np.int32)).to(dev),
            labels=torch.from_numpy(np.roll(toks, -1, -1).astype(np.int32))
            .to(dev), mask=torch.ones(shape, device=dev)))
    return cfg, params, batches


def tree_placed_run(torch, place):
    """Phase 3q (a)'s FedAWE run on tree state with K1 on card 0:
    unplaced (``place`` None: the fused K1 once a round) or as a rank of
    a ``TreePlacement`` (its rows and blocks over 'model': the partial
    form, the all-reduce, the finalize).  Returns the state and the
    metrics of each round."""
    import numpy as np

    from repro_torch.core import (AvailabilityCfg, FLConfig, init_fl_state,
                                  make_round_fn, prng)
    from repro_torch.models import model
    from repro_torch.sharding.placement import rows_of

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg, params, batches = tree_placed_inputs(torch, np, dev)
    trainable, frozen = model.split_trainable(params, cfg)
    fl = FLConfig(m=TREE_PLACED_M, s=cfg.local_steps, eta_l=0.05,
                  strategy="fedawe", use_kernel=True, grad_clip=0.5)
    round_fn = make_round_fn(
        fl, model.lm_loss_fn(cfg), frozen,
        AvailabilityCfg(kind="sine", gamma=0.3, period=4),
        torch.full((TREE_PLACED_M,), 0.6, device=dev), place=place)
    state = init_fl_state(prng.PRNGKey(3, dev), fl, trainable, place=place)
    hist = []
    for b in batches:
        state, metrics = round_fn(state, {k: rows_of(v, place)
                                          for k, v in b.items()})
        hist.append(metrics)
    torch.cuda.synchronize()
    return state, [{k: float(v) for k, v in h.items()} for h in hist]


def tree_placed_rank(torch, rank, shape=TREE_PLACED_MESH):
    """Phase 3q (a) on one rank of four: a ``shape`` ('data', 'model')
    mesh over the group's ranks, the run on its ``TreePlacement`` with
    every K1 form's count from 0 just before it (rank 0 under
    ``analysis.CollectiveCounter``), then its results gathered whole over
    'model' through a CPU twin of the sub-mesh (gloo's all-gather of
    CUDA tensors segfaulted on the card, torch 2.11)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.kernels.echo_aggregate import ops
    from repro_torch.launch import analysis, mesh
    from repro_torch.sharding import placements
    from repro_torch.sharding.placement import tree_placement

    m = DeviceMesh("cuda", torch.arange(4, device="cpu").reshape(shape),
                   mesh_dim_names=("data", "model"))
    place = tree_placement(m, TREE_PLACED_M)
    host = DeviceMesh("cpu", m.mesh,
                      mesh_dim_names=m.mesh_dim_names)["model"]
    ops.echo_aggregate_flat.launches = 0
    ops.echo_aggregate_flat.upload_launches = 0
    ops.echo_aggregate_partial.launches = 0
    ops.echo_aggregate_partial.upload_launches = 0
    ops.echo_aggregate_finalize.launches = 0
    collectives = None
    t0 = time.perf_counter()
    if rank == 0:
        with analysis.CollectiveCounter() as counter:
            state, hist = tree_placed_run(torch, place)
        collectives = dict(counter.collective_bytes(),
                           calls_by_op=dict(counter.calls_by_op),
                           bytes_by_op=dict(counter.bytes_by_op),
                           top=counter.collective_top())
    else:
        state, hist = tree_placed_run(torch, place)
    wall = time.perf_counter() - t0
    launches = dict(fused=ops.echo_aggregate_flat.launches,
                    fused_upload=ops.echo_aggregate_flat.upload_launches,
                    **partial_launches(ops))

    def whole(x):
        return DTensor.from_local(x.to_local().cpu(), host, x.placements,
                                  run_check=False).full_tensor()

    trainable = state.global_tr
    want = [tuple(placements(sp, place.sub))
            for sp in tree_leaves(place.client_specs(trainable))]
    return dict(
        mesh=mesh.mesh_axis_sizes(m), rows=(place.lo, place.hi),
        global_tr=[whole(v) for v in tree_leaves(state.global_tr)],
        clients=[whole(v) for v in tree_leaves(state.clients_tr)],
        n_local=sum(v.to_local().numel()
                    for v in tree_leaves(state.global_tr)),
        kept=[tuple(v.placements) for v in tree_leaves(state.clients_tr)]
        == want, tau=state.tau.cpu(), rng=state.rng.cpu(),
        markov=state.markov.cpu(), t=int(state.t), hist=hist,
        launches=launches, wall_s=wall, collectives=collectives)


def tree_placed_path(torch, ops, ref, ranks, counts, smi,
                     shape=TREE_PLACED_MESH, backend="gloo"):
    """Phase 3q (a): the unplaced tree round in this process (the fused
    K1 once a round), against the ranks' run (``tree_placed_rank``,
    spawned with phase 3o's).  Gates: every rank's partial form and
    finalize once a round, the fused K1 never; the globals and each
    rank's client rows within ``TREE_PLACED_TOL``, τ, markov, the key, t
    and the counts bit-equal, the client leaves on
    ``client_stack_pspecs``' placements; then the partial form at the
    rank's column shards ``[rows, N_local]`` held against its plain
    version (``PARTIAL_TOL``) and timed, beside its bound."""
    from repro_torch.core.tree_util import tree_leaves

    counts.reset()
    state, hist = tree_placed_run(torch, None)
    unplaced = counts.read()
    require(unplaced["K1"] == TREE_PLACED_ROUNDS,
            f"3q unplaced tree launches {unplaced}")
    g_want = [v.cpu() for v in tree_leaves(state.global_tr)]
    c_want = [v.cpu() for v in tree_leaves(state.clients_tr)]
    per = dict(fused=0, fused_upload=0, partial=TREE_PLACED_ROUNDS,
               partial_upload=0, finalize=TREE_PLACED_ROUNDS)
    rows = TREE_PLACED_M // shape[0]
    diff = 0.0
    for r, rk in enumerate(ranks):
        t = rk["tree"]
        require(t["mesh"] == dict(data=shape[0], model=shape[1]),
                f"3q mesh {t['mesh']}")
        require(t["launches"] == per, f"3q rank {r} launches "
                f"{t['launches']}")
        require(t["kept"], f"3q rank {r}: client leaves off their "
                "placements")
        lo, hi = t["rows"]
        require(hi - lo == rows, f"3q rank {r} rows {lo, hi}")
        for a, b in zip(t["global_tr"], g_want):
            diff = max(diff, (a - b).abs().max().item())
        for a, b in zip(t["clients"], c_want):
            diff = max(diff, (a - b[lo:hi]).abs().max().item())
        require(torch.equal(t["tau"], state.tau.cpu()[lo:hi])
                and torch.equal(t["markov"], state.markov.cpu()[lo:hi])
                and torch.equal(t["rng"], state.rng.cpu())
                and t["t"] == int(state.t), f"3q rank {r}: τ, markov, "
                "key or t differ from the unplaced run")
        for ha, hb in zip(t["hist"], hist):
            require(ha["n_active"] == hb["n_active"]
                    and abs(ha["loss"] - hb["loss"]) <= TREE_PLACED_TOL,
                    f"3q rank {r} metrics {ha} {hb}")
    require(diff <= TREE_PLACED_TOL, f"3q placed tree round differs by "
            f"{diff}")
    n = ranks[0]["tree"]["n_local"]
    # the partial form at the rank's column shards, against its plain
    # version, then timed in turns (operand sets rotating through more
    # than the L2)
    errs, sets = 0.0, []
    for j in range(64):
        a = make_inputs(torch, rows, n, torch.float32, seed=300 + j)
        sets.append(a)
        if j < 4:
            got = call_partial(ops.echo_aggregate_partial, a, 0, rows, False)
            want = call_partial(ref.echo_aggregate_partial_ref, a, 0, rows,
                                False)
            errs = max(errs, (got - want).abs().max().item())
    require(errs <= PARTIAL_TOL * max(1.0, n / N_MAIN),
            f"3q partial form at [{rows}, {n}] off by {errs}")

    def kern(i):
        return call_partial(ops.echo_aggregate_partial, sets[i % 64], 0,
                            rows, False)

    def plain(i):
        return call_partial(ref.echo_aggregate_partial_ref, sets[i % 64], 0,
                            rows, False)
    t = [graph_ms(torch, f, 64) for f in (kern, plain, plain, kern)]
    b_ms, b_by, nbytes = partial_bound(rows, n, False)
    timing = dict(ms=(t[0] + t[3]) / 2, turns_ms=[t[0], t[3]],
                  plain_ms=(t[1] + t[2]) / 2, bound_ms=b_ms, bound_by=b_by)
    del sets
    rec = dict(phase="tree_placed_path", card=smi, arch="tiny",
               dtype="float32", m=TREE_PLACED_M, rows_per_rank=rows,
               n_local=n, rounds=TREE_PLACED_ROUNDS, mesh=ranks[0]["tree"]
               ["mesh"], backend=backend, launches_per_rank=per,
               unplaced_launches=unplaced, max_diff=diff,
               tol=TREE_PLACED_TOL, placed_wall_s=max(
                   rk["tree"]["wall_s"] for rk in ranks),
               rank0_collectives=ranks[0]["tree"]["collectives"],
               partial_max_abs_err=errs, partial_bytes=nbytes,
               partial_share=b_ms / timing["ms"], **{
                   f"partial_{k}": v for k, v in timing.items()})
    emit(rec)
    return dict(timing, max_abs_err=errs, launches=per["partial"])


def lowering_tree_step(torch, smi):
    """Phase 3q (b): the dry run's tree step of ``TREE_STEP_ARCH`` x
    train_4k at full width (``TREE_STEP_LAYERS`` deep) as rank 0 of the
    (16, 16) mesh over fake CUDA tensors in a fake group
    (``dryrun.run_one(device="cuda")``), then the CPU dry run's record of
    the same combination.  Gates: both ``ok``; the collective bytes
    equal, the counted flops within ``TREE_STEP_FLOPS_RATIO`` of the
    CPU record's; the counted temp peak plus the step's argument bytes
    under the card's 80 GB; no card memory allocated by the fake
    step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cfg = get_config(TREE_STEP_ARCH).replace(n_layers=TREE_STEP_LAYERS)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rec = dryrun.run_one(TREE_STEP_ARCH, "train_4k", "single", cfg=cfg,
                         verbose=False, device="cuda")
    wall = time.perf_counter() - t0
    require(rec["ok"], f"3q tree step: {rec.get('error')}\n"
            f"{rec.get('traceback', '')}")
    require(torch.cuda.memory_allocated() == held,
            "3q: the fake tree step allocated card memory")
    t0 = time.perf_counter()
    cpu = dryrun.run_one(TREE_STEP_ARCH, "train_4k", "single", cfg=cfg,
                         verbose=False)
    cpu_wall = time.perf_counter() - t0
    require(cpu["ok"], f"3q CPU tree step: {cpu.get('error')}")
    got, want = (dict(flops=r["cost"]["flops"],
                      collective_bytes=r["collectives"]["total"])
                 for r in (rec, cpu))
    ratio = got["flops"] / want["flops"]
    require(got["collective_bytes"] == want["collective_bytes"]
            and TREE_STEP_FLOPS_RATIO[0] <= ratio
            <= TREE_STEP_FLOPS_RATIO[1], f"3q tree step counted {got} "
            f"over CUDA tensors; the CPU dry run's record {want}")
    mem = rec["memory"]
    need = mem["temp_size_in_bytes"] + mem["step_argument_size_in_bytes"]
    require(need < CARD_BYTES, f"3q tree step needs {need} bytes")
    emit(dict(phase="lowering_tree_step", card=smi, arch=TREE_STEP_ARCH,
              n_layers=TREE_STEP_LAYERS, shape="train_4k",
              mesh=rec["mesh_axes"], state=rec["state"],
              flops=got["flops"], cpu_flops=want["flops"],
              flops_over_cpu=ratio, analytic_flops=rec["analytic"]
              ["flops_per_dev"], flops_over_analytic=got["flops"]
              / rec["analytic"]["flops_per_dev"],
              collectives=rec["collectives"],
              collective_ops=rec["collective_ops"],
              temp_bytes=mem["temp_size_in_bytes"],
              step_argument_bytes=mem["step_argument_size_in_bytes"],
              need_bytes=need, run_s=rec["run_s"], wall_s=wall,
              cpu_run_s=cpu["run_s"], cpu_wall_s=cpu_wall))
    return rec


# ---------------------------------------------------------------------------

#: the port's example scripts and the arguments of their short runs here
EXAMPLES = {"quickstart": ["--rounds", "200"],
            "federated_lm": ["--rounds", "12"],
            "federated_image": ["--rounds", "8", "--out-dir",
                                os.path.join(REPO, "build", "examples")],
            "serve_demo": []}
#: the grid's seed mesh: N_SEEDS seeds of fedawe/sine at SEED_TASK in two
#: shards on the one card, MESH_ROUNDS rounds K = MESH_K at a time (a T %
#: K tail of 4), against the unsplit chunk: counts, τ, keys, t and markov
#: bit-equal, states and losses within MESH_TOL (tests/test_torch_mesh.py)
MESH_ROUNDS, MESH_K, MESH_TOL = 20, 8, 1e-6
#: the compile-cache runs: train on the main path's flags with the kernel
#: for 16 rounds, its libraries built (cold) or loaded (warm) in CACHE_DIR
CACHE_DIR = os.path.join(REPO, "build", "compile_cache_smoke")
CACHE_FLAGS = with_flags(MAIN_FLAGS, rounds=16) + [
    "--use-kernel", "--compile-cache", CACHE_DIR]
CACHE_RUN = ("import json, sys, time\n"
             "t0 = time.perf_counter()\n"
             "from repro_torch.launch import compilecache, train\n"
             "final = train.main(sys.argv[1:])\n"
             "print(json.dumps(dict(seconds=time.perf_counter() - t0,\n"
             "                      final=final,\n"
             "                      **compilecache.counters())))\n")


def start_cache_run():
    """One ``train ... --compile-cache CACHE_DIR`` in its own process:
    ``(process, start time)``; ``cache_run`` reads it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", CACHE_RUN, *CACHE_FLAGS],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)
    return proc, time.perf_counter()


def cache_run(run):
    """The result of ``start_cache_run``'s process: its seconds (wall,
    and inside Python from before the port's import), its hits and misses
    (``compilecache.counters``) and final eval; it must print the cache's
    path and exit 0."""
    proc, t0 = run
    out, err = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"compile-cache run failed ({proc.returncode}):\n{err[-4000:]}")
    require(f"compilation cache: {CACHE_DIR}\n" in out,
            f"compile-cache run printed no cache path:\n{out[-2000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    return dict(wall_s=wall, **rec)


def example_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(REPO, "examples", "torch",
                                        f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_path(torch, counts, smi):
    """The four example scripts of ``examples/torch`` on the card at short
    lengths, each through its ``main``: quickstart (FedAWE's bias below
    FedAvg's, its closing assertion), federated_lm (the loss falls, its
    closing assertion), federated_image (both runs' final eval finite,
    metrics and checkpoints written), serve_demo (every request served).
    None of them asks for a kernel, and none is launched."""
    shutil.rmtree(EXAMPLES["federated_image"][-1], ignore_errors=True)
    rec = {}
    for name, args in EXAMPLES.items():
        counts.reset()
        t0 = time.perf_counter()
        out = example_module(name).main(args + ["--device", "cuda"])
        torch.cuda.synchronize()
        rec[name] = dict(seconds=time.perf_counter() - t0,
                         launches=counts.read())
        if name == "quickstart":
            rec[name].update(fedavg=out[0], fedawe=out[1])
            require(abs(out[1] - 50) < abs(out[0] - 50),
                    f"quickstart: FedAWE's bias not below FedAvg's {out}")
        elif name == "federated_lm":
            losses = [h["loss"] for h in out]
            rec[name]["losses"] = losses
            require(losses[-1] < losses[0], f"federated_lm losses {losses}")
        elif name == "federated_image":
            rec[name]["eval_acc"] = out
            require(all(math.isfinite(v) for v in out.values()),
                    f"federated_image finals {out}")
            for strategy in out:
                stem = os.path.join(EXAMPLES[name][-1],
                                    f"example_image_{strategy}")
                require(os.path.exists(stem + ".json")
                        and os.path.exists(stem + "_ckpt.npz"),
                        f"federated_image wrote no {stem}")
        else:
            rec[name]["tok_per_s"] = out["tok_per_s"]
        require(rec[name]["launches"] == dict(K1=0, K2=0, K3=0, K4=0, K5=0),
                f"{name} launched {rec[name]['launches']}")
    emit(dict(phase="examples", card=smi, **rec))


def seed_mesh_path(torch, experiments, mesh, prng, counts, smi):
    """The grid's seed mesh on the card: fedawe/sine with the kernel,
    N_SEEDS seeds over ``make_seed_mesh(N_SEEDS, devices=[cuda:0,
    cuda:0])`` (two shards of two seeds, each its own seed chunk), through
    ``run_multi_seed`` as ``run_scenario`` drives it, every count at 0
    just before: K1 twice a round (once per shard), where the unsplit
    4-seed chunk, run the same way just before, launches it once.  Against
    that chunk: every history's counts, τ, keys, t and markov bit-equal,
    losses and states within MESH_TOL, final evals within 2 of 1 024."""
    dev = torch.device("cuda", 0)
    m = mesh.make_seed_mesh(N_SEEDS, devices=[dev, dev])
    require(mesh.mesh_axis_sizes(m) == {"seed": 2, "pod": 1, "data": 1},
            f"seed mesh {m}")
    runs = {}
    for tag, where in (("unsplit", None), ("mesh", m)):
        fl, rf, params, ds, eval_fn, _, _, _ = seed_cell(
            torch, experiments, "fedawe/sine")
        torch.cuda.synchronize()
        counts.reset()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop")
            states, hists, finals = experiments.run_multi_seed(
                fl, rf, params, ds, sampling="uniform",
                batch=SEED_TASK["batch"], seeds=N_SEEDS, rounds=MESH_ROUNDS,
                chunk_rounds=MESH_K, rng=prng.PRNGKey(0, dev),
                data_key=prng.PRNGKey(1, dev), eval_fn=eval_fn, mesh=where)
        torch.cuda.synchronize()
        runs[tag] = dict(states=states, hists=hists, finals=finals,
                         launches=counts.read(),
                         wall_s=time.perf_counter() - t0)
    a, b = runs["mesh"], runs["unsplit"]
    require(b["launches"] == dict(K1=MESH_ROUNDS, K2=0, K3=0, K4=0, K5=0),
            f"unsplit seed chunk launches {b['launches']}")
    require(a["launches"] == dict(K1=2 * MESH_ROUNDS, K2=0, K3=0, K4=0,
                                  K5=0),
            f"seed mesh launches {a['launches']}")
    loss_diff = 0.0
    for ha, hb in zip(a["hists"], b["hists"]):
        require(len(ha) == len(hb) == MESH_ROUNDS, "mesh history lengths")
        for ra, rb in zip(ha, hb):
            require(set(ra) == set(rb), f"metric keys {set(ra)}")
            require(all(ra[k] == rb[k] for k in ("n_active", "mean_echo",
                                                 "t")),
                    f"mesh counts differ: {ra} {rb}")
            require(math.isfinite(ra["loss"]), f"mesh loss {ra['loss']}")
            loss_diff = max(loss_diff, abs(ra["loss"] - rb["loss"]))
    sa, sb = a["states"], b["states"]
    for name in ("tau", "rng", "t", "markov"):
        require(torch.equal(getattr(sa, name), getattr(sb, name)),
                f"mesh {name} differs from the unsplit chunk")
    state_diff = max((getattr(sa, k) - getattr(sb, k)).abs().max().item()
                     for k in ("global_tr", "clients_tr"))
    eval_diff = max(abs(fa["eval_acc"] - fb["eval_acc"])
                    for fa, fb in zip(a["finals"], b["finals"]))
    require(loss_diff <= MESH_TOL and state_diff <= MESH_TOL,
            f"mesh vs unsplit: losses {loss_diff}, states {state_diff}")
    require(eval_diff <= 2 / 1024, f"mesh vs unsplit evals {eval_diff}")
    emit(dict(phase="seed_mesh_path", card=smi, scenario="fedawe/sine",
              seeds=N_SEEDS, mesh=mesh.mesh_axis_sizes(m),
              devices=[str(d) for d in m.devices], rounds=MESH_ROUNDS,
              chunk_rounds=MESH_K, launches=a["launches"],
              unsplit_launches=b["launches"], wall_s=a["wall_s"],
              unsplit_wall_s=b["wall_s"], max_loss_diff=loss_diff,
              max_state_diff=state_diff, max_eval_diff=eval_diff,
              tol=MESH_TOL))
    return a["launches"]


def compile_cache_path(cold, smi):
    """The kernel-library cache: the cold ``train --use-kernel
    --compile-cache CACHE_DIR`` started beside phase 1's builds (CACHE_DIR
    emptied first) ran nvcc (misses >= 1, no hit); a warm run of the same
    command now loads the library it left (hits >= 1, no miss); both give
    the same final eval."""
    warm = cache_run(start_cache_run())
    require(cold["misses"] >= 1 and cold["hits"] == 0,
            f"cold compile-cache run {cold}")
    require(warm["hits"] >= 1 and warm["misses"] == 0,
            f"warm compile-cache run {warm}")
    require(warm["final"] == cold["final"],
            f"cold and warm finals {cold['final']} {warm['final']}")
    emit(dict(phase="compile_cache", card=smi, cache_dir=CACHE_DIR,
              libraries=sorted(os.listdir(CACHE_DIR)), cold=cold, warm=warm))


class Counts:
    """Every kernel wrapper's launch count, set to 0 and read together."""

    def __init__(self, ops, fops, sops):
        self.ops, self.fops, self.sops = ops, fops, sops

    def reset(self):
        self.ops.echo_aggregate_flat.launches = 0
        self.ops.echo_aggregate_flat.upload_launches = 0
        self.ops.echo_aggregate.launches = 0
        self.ops.echo_aggregate_partial.launches = 0
        self.ops.echo_aggregate_partial.upload_launches = 0
        self.ops.echo_aggregate_finalize.launches = 0
        self.fops.flash_mha.launches = 0
        self.sops.ssd_chunk.launches = 0
        self.sops.ssd_chunk.wgmma_launches = 0

    def k5_wgmma(self):
        """K5 launches on the tensor-core route since the reset."""
        return self.sops.ssd_chunk.wgmma_launches

    def read(self):
        return {"K1": self.ops.echo_aggregate_flat.launches,
                "K2": self.ops.echo_aggregate_flat.upload_launches,
                "K3": self.ops.echo_aggregate.launches,
                "K4": self.fops.flash_mha.launches,
                "K5": self.sops.ssd_chunk.launches}


# ---------------------------------------------------------------------------

def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs the "
              "port on one card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import (FlatSpec, availability, engine, faults,
                                  prng, staleness, strategies)
    from repro_torch.data import federated
    from repro_torch.device import resolve_device
    from repro_torch.kernels.echo_aggregate import kernel, ops, ref
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_chunk import kernel as skernel
    from repro_torch.kernels.ssd_chunk import ops as sops
    from repro_torch.kernels.ssd_chunk import ref as sref
    from repro_torch.launch import analysis, experiments, mesh, serve, train
    from repro_torch.checkpointing import convert, io
    from repro_torch.models import cnn, layers, model, moe, reduced, ssm

    counts = Counts(ops, fops, sops)
    # K1-K3's kernel, K4's and K5's two are built by four nvcc processes,
    # started together
    build_pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
    builds = {"K1-K3": build_pool.submit(kernel.LIBRARY.build),
              "K4": build_pool.submit(fkernel.build),
              "K5": build_pool.submit(skernel.LIBRARY.build),
              "K5 wgmma": build_pool.submit(skernel.WGMMA_LIBRARY.build)}
    # the cold compile-cache run (phase 3n) builds its own K1-K3 library
    # beside them, in its own process, while nothing is timed
    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    cold_cache = start_cache_run()

    # phase 1: device
    smi = nvidia_smi()
    print(smi, flush=True)
    resolve_device("cuda")
    import triton
    emit(dict(phase="device", nvidia_smi=smi,
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, triton=triton.__version__,
              tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
              tf32_cudnn=torch.backends.cudnn.allow_tf32))

    # phase 2: kernels against their plain versions
    t0 = time.perf_counter()
    errs = check_kernels(torch, ops, ref)
    check_seed_axis(torch, ops, ref)
    tree_errs = check_tree_route(torch, ops, ref, strategies, cnn, prng,
                                 FlatSpec)
    partial_errs = check_partial(torch, ops, ref)
    t1 = time.perf_counter()
    for name, build in builds.items():
        lib = build.result()
        report = lib.with_suffix(".log").read_text()
        emit(dict(phase="kernel_build", kernel=name, library=str(lib),
                  wait_s=time.perf_counter() - t1,
                  ptxas=ptxas_report(report)))
    occupancy = {s: kernel.occupancy(s) for s in range(1, 9)}
    require(all(occupancy[s][0] == ops.blocks_per_sm(4, s)
                and kernel.smem_bytes(torch.float32, s)
                == ops.block_smem_bytes(4, s)
                and kernel.smem_bytes(torch.bfloat16, s)
                == ops.block_smem_bytes(2, s) for s in occupancy),
            f"launch_geometry's shared memory or residency is not the "
            f"kernel's: {occupancy}")
    emit(dict(phase="kernel_build", kernel="K1-K3",
              dynamic_smem_bytes={
                  f"{d} S{s}": kernel.smem_bytes(getattr(torch, d), s)
                  for d in ("float32", "bfloat16") for s in (1, 3, 8)},
              blocks_per_sm_and_clusters=occupancy,
              loads=load_widths(builds["K1-K3"].result())))
    emit(dict(phase="kernel_build", kernel="K4",
              bf16_dynamic_smem_bytes={D: fkernel.bf16_smem_bytes(D)
                                       for D in (64, 112, 128, 256)}))
    emit(dict(phase="kernel_build", kernel="K5 wgmma",
              dynamic_smem_bytes={N: skernel.wgmma_smem_bytes(N)
                                  for N in (64, 128)}))
    build_pool.shutdown()
    flash_err = check_flash(torch, fops, fref)
    ssd_err = check_ssd(torch, sops, sref)
    emit(dict(phase="kernel_checks_done", seconds=time.perf_counter() - t0))
    cold_cache = cache_run(cold_cache)

    # phase 3: the FL training path, every count at 0 just before it
    parser = train.build_parser()
    counts.reset()
    t0 = time.perf_counter()
    state_k, hist_k, final_k = train.run(
        parser.parse_args(MAIN_FLAGS + ["--use-kernel"]))
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = counts.read()
    losses = [h["loss"] for h in hist_k]
    n_active_k = [h["n_active"] for h in hist_k]
    require(len(hist_k) == 64, f"{len(hist_k)} rounds")
    require(launches == dict(K1=64, K2=0, K3=0, K4=0, K5=0),
            f"FL path launches {launches}")
    require(all(math.isfinite(v) for v in losses), f"losses {losses}")
    require(state_k.global_tr.shape == (N_MAIN,)
            and bool(torch.isfinite(state_k.global_tr).all()),
            "final global not finite of shape [N]")
    require(0 < sum(n_active_k) < 64 * M_MAIN, f"n_active {n_active_k}")

    t0 = time.perf_counter()
    state_p, hist_p, final_p = train.run(parser.parse_args(MAIN_FLAGS))
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    # the run without --use-kernel launched nothing
    require(ops.echo_aggregate_flat.launches == 64, "plain run launched K1")
    n_active_p = [h["n_active"] for h in hist_p]
    require(n_active_k == n_active_p, "n_active histories differ")
    diff = (state_k.global_tr - state_p.global_tr).abs().max().item()
    require(diff <= 1e-4, f"kernel vs plain global differ by {diff}")
    emit(dict(phase="main_path", rounds=64, m=M_MAIN, n=N_MAIN,
              launches=launches, wall_s_kernel=wall_k, wall_s_plain=wall_p,
              first_loss=losses[0], last_loss=losses[-1],
              empty_rounds=n_active_k.count(0.0),
              mean_active=sum(n_active_k) / 64, final_eval_acc=final_k,
              final_eval_acc_plain=final_p, kernel_vs_plain_global=diff))

    # phase 3b: the LM serving path, every count at 0 just before it
    lm_cfg = lm_config(get_config, "bfloat16")
    lm_params = lm_weights(torch, model, lm_cfg)
    tokens = lm_tokens(torch, lm_cfg.vocab)
    lm_launches = lm_main_path(torch, model, lm_cfg, lm_params, tokens,
                               counts)[0]
    torch.cuda.empty_cache()
    # phase 3c: flash against xla, on the reference's witness inputs and
    # at full width; decode parity when small
    drift_witness(torch, np, model, convert, get_config, reduced)
    flash_vs_xla(torch, model, lm_cfg, lm_params, tokens)
    decode_parity_small(torch, model, get_config, reduced)

    # phase 3d: the Mamba2 serving path, every count at 0 just before it;
    # then the SSD kernel route against the plain route, and decode
    # parity when small
    z_cfg = zamba_config(get_config, "bfloat16")
    z_params = lm_weights(torch, model, z_cfg, seed=2)
    z_tokens = lm_tokens(torch, z_cfg.vocab, seed=3)
    z_launches = zamba_main_path(torch, model, z_cfg, z_params, z_tokens,
                                 counts)
    ssd_vs_plain(torch, model, ssm, sops, z_cfg, z_params, z_tokens)
    zamba_parity_small(torch, model, get_config, reduced)

    # phase 3e: the fault and stale FL path, every count at 0 just before
    # it; the all-dropped run; the NaN witness and its negative control
    fault_launches = fault_main_path(torch, train, staleness, counts)
    for sanitize in (True, False):
        nan_witness(torch, train, engine, faults, federated, prng, counts,
                    sanitize)

    # phase 3f: the ten strategies, every count at 0 just before each; four
    # of them under faults and staleness; epoch sampling in both executors;
    # a run stopped and resumed from its artifact
    strategies_main_path(torch, train, strategies, counts, smi)
    strategies_fault_path(torch, train, staleness, counts, smi)
    epoch_and_resume(torch, train, federated, io, smi)

    # phase 3g: the seed-batched executor and the grid, every count at 0
    # just before each path: 4 seeds of FedAWE with K1, of the fault and
    # stale cell with K2, the packed speedup-sine grid against its cells
    t0 = time.perf_counter()
    seeds_main_path(torch, experiments, engine, federated, prng, counts, smi)
    seeds_fault_path(torch, experiments, prng, staleness, counts, smi)
    packed_grid_path(torch, experiments, counts, smi)
    emit(dict(phase="seeds_paths_done", seconds=time.perf_counter() - t0))

    # phase 3h: the sparse cohort round, every count at 0 just before each
    # path: FedAWE and MIFA at m = 10^5 (K1 on [256, N]), the cohort
    # against the dense run at m = 100, 4 seeds of the cohort
    t0 = time.perf_counter()
    cohort_scale_path(torch, engine, federated, cnn, prng, availability,
                      ops, ref, counts, smi)
    cohort_dense_path(torch, train, counts, smi)
    cohort_seeds_path(torch, train, engine, experiments, federated, prng,
                      counts, smi)
    emit(dict(phase="cohort_paths_done", seconds=time.perf_counter() - t0))

    # phase 3i: the tree-state round (the JAX package's default substrate),
    # every count at 0 just before each path: K1 and K2 through the tree
    # route against the flat runs, the ten strategies, 4 seeds, the paper
    # harness's linear model built from the engine
    t0 = time.perf_counter()
    tree_launches = tree_main_path(torch, train, ops, counts,
                                   (state_k, hist_k), smi)
    tree_strategies_path(torch, train, engine, federated, strategies,
                         counts, smi)
    tree_seeds_path(torch, train, engine, federated, prng, ops, counts, smi)
    tree_linear_path(torch, engine, cnn, prng, availability, ops, counts,
                     smi)
    emit(dict(phase="tree_paths_done", seconds=time.perf_counter() - t0))

    # phase 4: numbers
    triton_load_widths(torch, ops, smi)
    times = time_kernels(torch, ops, ref, strategies, smi)
    runs = []
    for use_kernel in (True, False, False, True):
        r = time_rounds(torch, train, engine, federated, prng, use_kernel)
        runs.append(r)
        emit(dict(phase="round_time", card=smi, use_kernel=use_kernel,
                  round_ms=r["round_ms"], rounds_per_s=r["rounds_per_s"]))
    round_ms = (runs[0]["round_ms"] + runs[3]["round_ms"]) / 2
    parts = round_parts_ms(torch, prng, engine, strategies, cnn, runs[3])
    emit(dict(phase="round_parts", card=smi, round_ms=round_ms, **parts,
              prng_share=parts["prng_ms"] / round_ms))
    emit(dict(phase="profile", card=smi, use_kernel=True,
              **profile_chunk(torch, runs[3], round_ms)))
    del runs
    time_fault_path(torch, train, engine, federated, prng, staleness, smi)
    time_strategies(torch, train, engine, federated, smi)
    time_seeds(torch, train, engine, experiments, federated, ops, smi)
    tree_times = time_tree_route(torch, ops, ref, cnn, prng, FlatSpec, smi)
    time_tree_rounds(torch, train, engine, federated, smi)
    for arch in ("zamba2-7b", "mamba2-130m"):
        emit(dict(phase="bound", **ssd_chunk_bound(get_config(arch), LM_B,
                                                   LM_L, 2)))
    # the LM paths are timed before the flex_attention yardstick compiles:
    # torch.compile's worker processes would share the host with decode
    time_lm(torch, model, lm_cfg, lm_params, tokens, smi)
    time_serve(torch, model, z_cfg, z_params, z_tokens, smi, "zamba",
               ZAMBA_PARTS)
    del z_params, lm_params
    torch.cuda.empty_cache()

    # phase 3j: MoE serving, every count at 0 just before each main path:
    # olmoe-1b-7b and moonshot-v1-16b-a3b (its 57.8 GB of weights need the
    # dense and Mamba2 models' freed first, so the phase runs here, its
    # numbers with it)
    moe_launches = moe_paths(torch, model, moe, serve, get_config, reduced,
                             counts, smi)
    # phase 3k: encoder-decoder and frontend serving, every count at 0
    # just before each main path: seamless-m4t-large-v2 (K4 at head dim
    # 64) and internvl2-2b (head dim 128, two query heads per kv head)
    encdec_launches = encdec_paths(torch, model, serve, get_config, reduced,
                                   counts, smi)
    # phase 3l: full-parameter federated LM training, every count at 0 just
    # before each main path: train --preset lm (K1, K2), mamba2-130m at
    # full width and depth (K1 at [8, N]), the reduced architectures
    lm_k1 = lm_train_paths(
        torch, np, model, engine, federated, availability, prng, ops, ref,
        train, get_config, reduced, counts, smi)
    # phase 3m: LoRA at full width, every count at 0 just before each main
    # path: gemma3-27b serving with its adapters (K4 62 times a prefill)
    # and training them over its frozen base (K1 on the [4, N] stack),
    # one base for both, freed before the numbers below
    lora = lora_paths(torch, np, model, layers, engine, federated,
                      availability, prng, ops, ref, get_config, counts, smi)
    # phase 3n: every count at 0 just before each path: the four example
    # scripts, the grid's seed mesh (K1 twice a round, once per shard)
    # against the unsplit chunk, and the kernel-library cache warm
    t0 = time.perf_counter()
    examples_path(torch, counts, smi)
    mesh_launches = seed_mesh_path(torch, experiments, mesh, prng, counts,
                                   smi)
    compile_cache_path(cold_cache, smi)
    emit(dict(phase="mesh_examples_done", seconds=time.perf_counter() - t0,
              seed_mesh_launches=mesh_launches))
    # phase 3o: the placed FL path, every count at 0 just before each run:
    # two seeds' clients over four ranks on card 0 (the partial form, the
    # all-reduce and the finalize) against the unplaced 2-seed run
    t0 = time.perf_counter()
    placed = placed_fl_path(torch, experiments, prng, ops, counts, smi)
    partial_times = time_partial(torch, ops, ref, smi)
    emit(dict(phase="placed_done", seconds=time.perf_counter() - t0))
    # phase 3p: the dry run's counters against real runs, every count at 0
    # just before each run: gemma2-2b's prefill on the card and over fake
    # tensors, and the placed round's collectives counted in phase 3o
    t0 = time.perf_counter()
    lowering_prefill(torch, model, analysis, get_config, counts, smi)
    lowering_placed_round(placed, smi)
    emit(dict(phase="lowering_done", seconds=time.perf_counter() - t0))
    # phase 3q: the tree-state placed round, every count at 0 just before
    # each run: tiny over phase 3o's ranks on a (2, 2) ('data', 'model')
    # mesh (K1's partial form on each rank's column shards) against the
    # unplaced tree round, and gemma2-2b's dry-run tree step over fake
    # CUDA tensors against the CPU dry run's record
    t0 = time.perf_counter()
    tree_partial = tree_placed_path(torch, ops, ref, placed["ranks"], counts,
                                    smi)
    lowering_tree_step(torch, smi)
    emit(dict(phase="tree_placed_done", seconds=time.perf_counter() - t0))

    ssd_times = time_ssd(torch, sops, sref, get_config, smi)
    time_flash_sdpa(torch, fops, fref, smi, "zamba2-7b", ZAMBA_ATTN,
                    ZAMBA_ATTN_CHECK[0])
    moe_flash = time_flash_sdpa(torch, fops, fref, smi, "olmoe-1b-7b",
                                OLMOE_ATTN, OLMOE_ATTN)
    encdec_flash = {arch: time_flash_sdpa(torch, fops, fref, smi, arch, case,
                                          case)
                    for arch, case in zip(ENCDEC_ARCHS, ENCDEC_ATTN_CHECK)}
    gemma3_flash = time_flash_gemma3(torch, fops, fref, smi)
    flash_times = time_flash(torch, fops, fref, smi)
    torch.cuda.empty_cache()
    print(smi, flush=True)

    # phase 5
    kernels = []
    replaces = {
        "K1": "src/repro/kernels/echo_aggregate/kernel.py:100",
        "K2": "src/repro/kernels/echo_aggregate/kernel.py:100",
        "K3": "src/repro/kernels/echo_aggregate/kernel.py:48"}
    names = {"K1": "echo_aggregate_fused (K1)",
             "K2": "echo_aggregate_fused_upload (K2)",
             "K3": "echo_aggregate (K3)"}
    # K1 launches on the FL path, K2 on the fault and stale path, K3 on none
    path_launches = dict(K1=launches["K1"], K2=fault_launches["K2"],
                         K3=launches["K3"])
    for v in ("K1", "K2", "K3"):
        t = times[v]
        kernels.append(dict(
            name=names[v], route="cuda",
            source="src/repro_torch/kernels/echo_aggregate/csrc/"
                   "echo_aggregate.cu",
            replaces=replaces[v], launches=path_launches[v],
            max_abs_err=errs[v], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None))
    # K1 and K2 through the tree route (``ops.echo_aggregate_tree``): the
    # same kernel, one launch a round over the raveled leaves; its time is
    # the route's (concatenations and launch), its launches the tree paths'
    for v in ("K1", "K2"):
        t = tree_times[v]
        kernels.append(dict(
            name=names[v] + ", tree route", route="cuda",
            source="src/repro_torch/kernels/echo_aggregate/csrc/"
                   "echo_aggregate.cu",
            replaces=replaces[v], launches=tree_launches[v],
            max_abs_err=tree_errs[v], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None))
    # K1 / K2's partial form and the finalize: per launch at a placed
    # rank's rows of the FL path, [50, N] float32; their launches are rank
    # 0's in phase 3o (the finalize's over both cells)
    for v, key in (("K1", "partial"), ("K2", "partial_upload")):
        t = partial_times[f"{v} partial"]
        kernels.append(dict(
            name=f"{names[v]}, partial form", route="cuda",
            source="src/repro_torch/kernels/echo_aggregate/csrc/"
                   "echo_aggregate.cu",
            replaces=replaces[v], launches=placed[key],
            max_abs_err=partial_errs[f"{v} partial"],
            max_err_of_largest=partial_errs[f"{v} partial, of the largest"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None))
    # K1's partial form on the tree route: a TreePlacement rank's rows of
    # phase 3q's tiny round over its column shards, [4, N_local] float32;
    # its launches rank 0's there
    kernels.append(dict(
        name=f"{names['K1']}, partial form, tree route", route="cuda",
        source="src/repro_torch/kernels/echo_aggregate/csrc/"
               "echo_aggregate.cu",
        replaces=replaces["K1"], launches=tree_partial["launches"],
        max_abs_err=tree_partial["max_abs_err"], ms=tree_partial["ms"],
        plain_ms=tree_partial["plain_ms"], bound_ms=tree_partial["bound_ms"],
        bound_by=tree_partial["bound_by"], library_ms=None))
    t = partial_times["finalize"]
    kernels.append(dict(
        name="echo_aggregate_finalize (K1 / K2 partial form's finalize)",
        route="cuda",
        source="src/repro_torch/kernels/echo_aggregate/csrc/"
               "echo_aggregate.cu",
        replaces=replaces["K1"], launches=placed["finalize"],
        max_abs_err=partial_errs["finalize"], ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None))
    # K1 on the LM training stack: mamba2-130m's [8, 1.29e8] float32 flat
    # state, one launch a round of the full-width run
    kernels.append(dict(
        name=names["K1"] + ", LM stack [8, N]", route="cuda",
        source="src/repro_torch/kernels/echo_aggregate/csrc/"
               "echo_aggregate.cu",
        replaces=replaces["K1"], launches=lm_k1["launches"],
        max_abs_err=lm_k1["max_abs_err"], ms=lm_k1["ms"],
        plain_ms=lm_k1["plain_ms"], bound_ms=lm_k1["bound_ms"],
        bound_by=lm_k1["bound_by"], library_ms=None))
    # K1 on the LoRA stack: gemma3-27b's [4, 3.35e7] float32 flat state of
    # adapters, one launch a round of the full-width LoRA run
    kernels.append(dict(
        name=names["K1"] + ", LoRA stack [4, N]", route="cuda",
        source="src/repro_torch/kernels/echo_aggregate/csrc/"
               "echo_aggregate.cu",
        replaces=replaces["K1"], launches=lora["k1"]["launches"],
        max_abs_err=lora["k1"]["max_abs_err"], ms=lora["k1"]["ms"],
        plain_ms=lora["k1"]["plain_ms"], bound_ms=lora["k1"]["bound_ms"],
        bound_by=lora["k1"]["bound_by"], library_ms=None))
    # K4 at gemma3-27b's attention (B 2, 32 query over 16 kv heads of 128,
    # L = S = 8192), per launch: windowed (1 024; compiled flex_attention
    # with the sliding-window mask computes the same function) and global
    # (SDPA, is_causal and enable_gqa), their launches the LoRA prefill's
    for tag, window in (("windowed", LORA_WINDOW), ("global", None)):
        t = gemma3_flash[tag]
        kernels.append(dict(
            name=f"flash_attention (K4), gemma3-27b {tag}", route="cuda",
            source="src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:90",
            launches=lora["windows"].count(window),
            max_abs_err=flash_err[f"gemma3_{tag}"], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    require(sum(k["launches"] for k in kernels[-2:]) == lora["k4"],
            f"gemma3 K4 launches {lora['k4']}")
    # K4: per launch, the mean of the prefill's two shapes (13 windowed and
    # 13 global launches)
    both = list(flash_times.values())

    def mean(key):
        return sum(t[key] for t in both) / len(both)

    kernels.append(dict(
        name="flash_attention (K4)", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:90",
        launches=lm_launches["K4"], max_abs_err=flash_err["gemma"],
        ms=mean("ms"), plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by=both[0]["bound_by"], library_ms=mean("library_ms")))
    # K4 at head dim 128: per launch at olmoe-1b-7b's attention, which is
    # moonshot-v1-16b-a3b's too (B 2, 16 heads, L = S = 8192, global); its
    # launches are both MoE prefills'; SDPA computes the same function
    kernels.append(dict(
        name="flash_attention (K4), head dim 128", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:90",
        launches=sum(n["K4"] for n in moe_launches.values()),
        max_abs_err=flash_err["olmoe"], ms=moe_flash["ms"],
        plain_ms=moe_flash["plain_ms_at_cut"],
        bound_ms=moe_flash["bound_ms"], bound_by=moe_flash["bound_by"],
        library_ms=moe_flash["library_ms"]))
    # K4 at head dim 64 (seamless-m4t-large-v2's decoder self-attention:
    # B 2, 16 heads, L = S = 8192, global) and at head dim 128 with two
    # query heads per kv head (internvl2-2b's: 16 over 8), per launch; the
    # launches are each model's prefill's; SDPA (is_causal, enable_gqa)
    # computes the same function there
    for arch, name, key in (
            ("seamless-m4t-large-v2", "head dim 64", "seamless"),
            ("internvl2-2b", "head dim 128, two query heads per kv head",
             "internvl")):
        t = encdec_flash[arch]
        kernels.append(dict(
            name=f"flash_attention (K4), {name}", route="cuda",
            source="src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:90",
            launches=encdec_launches[arch]["K4"], max_abs_err=flash_err[key],
            ms=t["ms"], plain_ms=t["plain_ms_at_cut"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    # K5: per launch at zamba2-7b's shape (the main path's 68 launches, all
    # on the tensor-core kernel)
    zt = ssd_times["zamba2-7b"]
    kernels.append(dict(
        name="ssd_chunk (K5)", route="cuda",
        source="src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk_wgmma.cu",
        replaces="src/repro/kernels/ssd_chunk/kernel.py:51",
        launches=z_launches["K5"], max_abs_err=ssd_err, ms=zt["ms"],
        plain_ms=zt["plain_ms"], bound_ms=zt["bound_ms"],
        bound_by=zt["bound_by"], library_ms=None))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
