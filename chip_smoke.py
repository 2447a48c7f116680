#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``tcnn_tpu_torch``) on one card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, and drives the port's
paths at full width, each with the launch counts set to 0 just before it
and read just after:
  * config_hash (2-D hash grid, FullyFusedMLP 64 x 2): serving requests
    through ``model.trainer.inference`` (slice 1), training through
    ``model.trainer.training_step`` and ``make_training_loop`` (slice 2);
  * config_btf (Composite of a 4-D CoherentAdd hash grid of 15,474,688
    parameters and OneBlob, FullyFusedMLP 64 x 3, 40 inputs): one request
    of 2^18 and training, the same entry points (slice 3);
  * config_oneblob (OneBlob of 64 bins into a FullyFusedMLP 128 x 5, the
    shape kernel MB takes at half tiles): M and MB against their plain
    versions at B = 2^18, one training step's gradients against the plain
    path, and 300 steps of ``make_training_loop`` on the image, with a
    loss floor from the JAX package's run of the same fit (slice 6);
  * the SDF sample (3-D Smoothstep hash grid 8 x 2, 2^15-row tables,
    FullyFusedMLP 64 x 2, 16 -> 1, fp32): kernels GI and GG against their
    plain versions at B = 2^18 (f32 and bf16 tables; GG's d_dcols and d_x
    bit for bit in a second launch), one eikonal step's gradients against
    the plain eikonal step, and the sample's fit,
    ``samples/fit_sdf_eikonal.main``, 500 steps at 2^14 through
    ``create_from_config``, ``model.network`` and ``model.optimizer``: the
    second-order main path, whose launch counts of G, M, MB, GB, GI and GG
    it checks (slice 4; since slice 21 the fit replays a captured step, so
    the step's kernels launch in its eager warm-up and in the capture; GB
    once a step, and none in ``Module.input_gradient``: a table gradient
    the engine would drop is not computed; no RS: GG adds its table
    gradient itself).  Kernel RS,
    which no path of the port calls, in a phase of its own: its entry
    points (``scatter_add_rows``, ``_flat``, ``_cols``) on GG's updates at
    the SDF layout as (rows, g) (``plain_path.gg_rows_and_g``), F in
    {1, 2, 4, 8} on random rows and row 10's column streams, against its
    plain version, and timed beside ``index_add_``;
  * the NeRF field sample (slice 8: a 3-D HashGrid of 12 levels x 2,
    2^17-row tables, into a FullyFusedMLP 64 x 1, 24 -> 16; a Composite of
    Identity and SphericalHarmonics into a FullyFusedMLP 64 x 2, 31 -> 3,
    Sigmoid; BF16_POLICY): G and GB under per-sample level masks, and M
    and MB at the two nets' shapes, against their plain versions at the
    sample's 2^12 rays x 48 samples = 196,608 points; one training step's
    gradients of both nets against the plain path's; a step's launches (G
    1, M 2, GB 1, MB 2); the sample's fit, ``samples/fit_nerf_field.main``
    at its defaults (400 steps, coarse-to-fine over the first 100; a
    captured step replayed since slice 21), the main path, with a PSNR
    floor; then the image sample,
    ``samples/mlp_learning_an_image.main``, 100 steps into a temporary
    directory;
  * save, load and serve (slice 9, config_hash at BF16_POLICY and
    B = 2^18): 200 steps of EMA(Adam) through ``make_training_loop`` (PSNR
    floor 20 dB with the EMA weights, which must differ from the raw
    ones); the CUDA original's snapshot through the port's msgpack codec
    into a fresh model (inference bits equal); ``serialize`` /
    ``deserialize`` and ``save_checkpoint`` / ``restore_checkpoint`` into
    fresh trainers (inference bits equal, the next step's gradients as
    below); a serving bundle at buckets 2^10, 2^14, 2^16, 2^18 loaded on
    the card (one warm-up request and one capture per bucket: G and M 5
    times each; requests of 1 to 2^18 rows replay a graph and equal
    ``Trainer.inference`` bit for bit); ``export_train_step`` /
    ``load_train_step``, 10 steps against ``training_step``; and SGD,
    Novograd, Average, Batched, Lookahead, ExponentialDecay, Composite and
    Shampoo at config_hash: one optimizer step on the card against the
    same step on the CPU, 20 replayed steps against 20 eager ones
    (Shampoo's too since slice 23, its roots refreshed by kernel SR at
    t = 1, 10 and 20; at t = 10 against float64 roots), and each optimizer
    step's time in a CUDA graph;
  * tiny-cuda-nn's torch modules (slice 10, ``bindings.torch_interop``,
    fp32): a ``NetworkWithInputEncoding`` at config_hash's full width,
    B = 2^18, its forward, ``params.grad`` and input gradient against the
    plain path (launches G, M, GB, MB, GI once each); the SDF sample's
    eikonal step through a ``NetworkWithInputEncoding`` at the SDF grid
    against the plain eikonal step (double backward: GI and GG, and no
    GB under ``torch.autograd.grad(y, x)``); ``Encoding(dtype=
    torch.float16)``; a pickle round trip; the ported image sample,
    ``samples/mlp_learning_an_image_pytorch.main`` at the JAX sample's
    settings (1000 eager steps of 2^14 pixels, ``torch.optim.Adam``), the
    main path, with a PSNR floor; and the binding's eager step at 2^18
    beside ``make_training_loop``'s on the same model (``slice_times`` in
    fp32);
  * slice 11, what the port once refused: config_hash with ``"hash":
    "Rng"`` and ``"stochastic_interpolation": true`` (BF16_POLICY, 2^18): G,
    GB, GI and GG (Rng, each kernel's run-time-D instance) and GB
    (stochastic, JAX's uniforms) against their plain versions, 200 steps
    of ``make_training_loop`` (the loss falls; PSNR above 20 dB) and an
    input gradient's second order, the main path, and the step beside
    config_hash's; the SDF model's eikonal step with a per-sample fraction
    of 0.5 (GG masked) against the same step through the plain versions;
    5- and 7-D grids through G, GB, GI and GG, and a 7-D eikonal step
    on each of 20 draws of weights and points;
    kernel MB at 128 x 12 hidden layers (two launches, M at their
    boundary) in both dtypes and three training steps with that MLP per
    policy; ``torch.func.jvp`` and ``jacrev`` (4 rows' outputs) of
    config_hash's network at 2^18 against the same transforms of the plain
    versions, and a training step's launches after them.
  * slice 12, parallelism: config_btf's grid row-sharded 2 ways (B = 2^18,
    both table dtypes): G, GB, GI and GG in shard mode on each shard
    against their plain versions, the shards' partials against the
    unsharded kernels, and their times; then two gloo ranks on this one
    card (``tools/parallel_check.py``), the main path: ``HybridParallel``
    (n_model 2) training config_btf's full model (2^18, 20 steps),
    ``DataParallel`` training config_hash (2^18, 20 steps) and the SDF
    sample's eikonal loss under ``HybridParallel`` (2^14, 5 steps), each
    against the same training in this process, with the ranks' launches,
    step and collective times (one card shared by two processes: no
    scaling figure); on the card ``make_training_loop`` refuses gloo in
    each rank before a step (slice 18).
  * slice 18, the parallel training loop: in a spawned process with a
    one-rank NCCL group (one card holds one NCCL rank),
    ``DataParallel.make_training_loop`` trains config_hash (BF16_POLICY,
    2^18, 50 steps; the warm-up step eagerly, then a captured CUDA graph of
    the step replayed), the main path, against ``Trainer.make_training_loop``
    on the same batches in that process, with G, GB, M and MB's launches in
    the warm-up and in each replay, and both loops' ms per step and idle
    share; in the same group each collective the parallel steps use
    (``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``),
    which the port's wrappers skip at one rank, replayed from a CUDA graph
    against eager calls, bit for bit.
  * slice 14, third derivatives and Queue 1 item 16: kernel GT (the grid's
    third order, on GB's plan) against its plain version in each instance
    family, with all outputs and with the curvature step's (no d_x): the
    compile-time 3-D instance at the SDF grid (fp32, 2^18 and 2^14), the
    4-D one at config_btf's CoherentAdd grid (bf16 table and cotangent,
    2^14), the run-time-D instance at the SDF grid with the Rng hash, under
    a mask at 0.5 and on shard 0 of 2; G's stochastic gather at the
    Rng and stochastic config_hash geometry, and a loss on that grid's
    table gradient differentiated in x; the curvature step (the eikonal
    loss plus 1e-3 · mean |H v|², ``samples/fit_sdf_eikonal.curvature_loss``)
    of the SDF sample's model, ReLU and Softplus, against
    ``plain_path.plain_curvature_loss_and_grads`` with its launches, 200
    steps of it at 2^14 (the main path of GT, with a loss floor from the
    JAX package's run; one GT launch a step) and its times at 2^18 beside
    the eikonal step's; M and MB at 64 x 40 hidden
    layers (beyond one launch); a config_hash fit fed by
    ``utils.native_loader.PrefetchingSampler`` against the same fit on the
    on-device sampler (PSNR by ``utils.metrics``); one eager eikonal step
    under ``utils.profiling.trace``.
  * slice 16, wide features: grids of more than 8 features a level (each
    grid kernel's run-time-D instance takes them in groups of 8) and
    FusedMLPs whose first layer does not fit one CTA's shared memory (that
    layer alone through the streamed-layer instances of M and MB,
    ``csrc/fused_mlp_wide.cu``; the other layers through M and MB).  G, GB,
    GI, GG and GT at F = 16 (the wide SDF's grid: 3-D Smoothstep, 16 levels,
    2^19-row tables, fp32) and F = 32 (the wide image's: config_hash's
    geometry, bf16 table) against their plain versions at 2^16 and timed at
    2^18; M and MB at 256 (fp32) and 512 (bf16) inputs, 128 x 2, and the
    streamed-layer instances alone on their first layers; the wide SDF
    (FullyFusedMLP 128 x 2, 256 inputs) through its eikonal step and, with
    Softplus hidden layers, its curvature step at 2^18 against the plain
    path, with their launches, device times and the profiler's split, and
    200 eikonal steps at 2^14 (2^15-row tables, the size of the JAX
    package's reference run) with a loss floor;
    the wide image (512 inputs, BF16_POLICY) through one step's gradients
    against the plain path and 100 steps of ``make_training_loop`` at 2^18
    (the loss falls more than 10x).
  * slice 17, wide outputs: the streamed-layer kernels MW and MBW,
    redesigned on the tensor cores, take any number of output columns.
    Both at a 128 -> 600 last layer (bf16 and fp32, 2^18) against their
    plain versions, bit for bit across two launches, and timed beside their
    bounds and the cuBLAS products; config_hash's grid into a FullyFusedMLP
    128 x 2 with 600 outputs (past M's and MB's layouts: the last layer runs
    alone), in both policies, through one step's gradients against the
    plain path and 10 training steps at 2^16 (the loss falls; per step M
    twice, MBW and MB once, and MW once in fp32, where M's layout cannot
    hold the last layer).
  * slice 19, the deterministic table gradient (``TCNN_TPU_SCATTER=
    sortseg``, ``ops/sort_scatter.py``: kernel SK, ``torch.sort``, kernel
    SS): at config_hash's and config_btf's grids (2^18, bf16) SK against
    its plain version bit for bit, SS against its plain version within
    2^-23·(P + n·A) (P the largest |prefix sum| of the column, n and A the
    row's run length and sum of magnitudes), bit for bit twice and on
    small-integer values, the route against GB's plain version within
    2^-11·S plus one bf16 ulp, and the times of SK, the sort, SS, the route,
    GB and ``index_add_`` (atomic, and under
    ``torch.use_deterministic_algorithms(True)``, bit-identical twice: the
    sort and SS as one call), SS's bound and its gather's sector floor;
    the main path, config_hash trained through ``make_training_loop``
    under ``sortseg`` twice from one seed (200 steps at 2^18): every
    weight and loss bit-identical, SK and SS launched and
    GB not; the same fit with GB twice (the weights that differ, a number);
    the captured loop against the same 20 steps taken eagerly, bit for bit;
    the step on the device under each route at config_hash and config_btf
    with its peak memory; ``DataParallel.make_training_loop`` under
    ``sortseg`` on a one-rank NCCL group (its capture takes the sort; its
    losses and weights equal ``Trainer.make_training_loop``'s bit for bit).
  * slice 21, the compiled single step (``compiled_step_slice``, last):
    config_hash (BF16_POLICY, 2^18) through ``Trainer.make_training_step``,
    20 steps under ``sortseg`` bit for bit equal to 20 eager
    ``training_step``s from the same seed, then 20 steps without it, the
    main path (G, M, GB, MB in the warm-up and the capture only; each
    call's loss a tensor of its own), and Shampoo's compiled steps (slice
    23) against eager ones under ``sortseg``, bit for bit; the SDF
    sample's eikonal step at 2^14 and 2^18 and the NeRF step at the
    sample's defaults captured through the trainer's capture helper, a
    replayed step's loss and gradients against an eager step's from the
    same weights (the NeRF step eager under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync); each
    path's eager and replayed ms per step on the host clock (the least of
    5 passes of 20 steps) and the replayed step's device ms; the SDF
    sample's 500-step fit and the NeRF sample's fit, both replaying a
    captured step, the main paths of their kernels' entries.
  * slice 22, the compiled requests and the parallel layers' compiled
    entry points (``compiled_requests_slice``, last): ``Trainer.inference``
    on config_hash (BF16_POLICY) at 2^10, 2^14 and 2^18 and on config_btf
    at 2^18, a request run and captured and one replayed, both bit for bit
    the eager module's, G and M launched by the first only, the main path
    of the requests; each request's eager and compiled ms and the
    replay's device ms; config_btf's graph pool; EMA(Adam): a request
    replayed after 10 more eager steps against the eager module on the EMA
    weights; ``forward`` and ``evaluate_loss``; in a spawned one-rank NCCL
    process ``DataParallel`` and ``HybridParallel`` (n_model 1)
    ``make_training_step`` under ``sortseg``, 20 steps bit for bit against
    ``step_shard_map`` eager steps and ``Trainer.make_training_step``, their
    ``make_inference`` against the eager module, and DataParallel's
    compiled step without it (G, GB, M, MB in the warm-up and the capture
    only), the main path of the parallel step, with the three steps'
    times.  (Since slice 22 every earlier phase's first request of a shape
    launches G and M twice, its warm-up and its capture.)
  * slice 23, Shampoo in the compiled paths (``shampoo_slice``, last):
    config_hash (BF16_POLICY, 2^18) with Shampoo through
    ``make_training_loop`` under ``sortseg``, 250 steps, the main path of
    kernel SR (launched in the warm-up and the capture, each replay
    reading the step counter itself), against 250 eager steps bit for bit,
    the roots changing at exactly t = 1, 10, ..., 90, 200; SR against
    the float64 roots of the same float32 S within ``ROOT_TOL`` (32 ulps
    of the root's largest entry) at config_hash's and config_oneblob's
    preconditioners and n = 256, 512, 600, beside float32 eigh's error and
    a control that must fail (SR stopped at half its sweeps), with its
    sweeps and times beside the eigh yardstick; Shampoo's loop, compiled,
    eager and optimizer-alone times at config_hash beside Adam's, and
    config_oneblob's loop with each; DataParallel's and HybridParallel's
    ``make_training_step`` with Shampoo on a one-rank NCCL group against
    eager and trainer steps, bit for bit.
It times the kernels, a request and a training step of both, the eikonal
step (eager, and on the device from a captured CUDA graph) and its
kernels, checks that two launches of kernel MB on the same inputs give
the same dW bits (SDF and config_btf shapes, both compute dtypes), and
prints:

    ... one line per phase ...
    {"kernels": [...]}                       per-kernel numbers
    <name>, <power limit>                    as nvidia-smi gives them
    {"ok": true, "device": {...}}            last line

Any failure raises, so the exit code is nonzero and the last line is
missing.  It needs one CUDA device and fails without one.  It imports
nothing of JAX and nothing of the JAX package ``tcnn_tpu``.

Tolerances (the plain version runs on the same tensors on the card,
with TF32 off):
  * grid encode, float32 table: |d| <= 1e-5·|ref| + 1e-6 (fp32 corner
    sum in another order); bfloat16 table: |d| <= one bf16 ulp of ref
    (the fp32 sum may round to the other neighbour).  At config_btf's 4-D
    grid the bf16 bound adds the fp32 sum's own error, (2^D + 2D)·2^-24 =
    1.43e-6: 16 corner terms, each a product of 4 weights, with the
    weights summing to 1 and the U(±1) table bounding each term by 1;
    where the terms cancel to a value near 0, that error is many bf16
    ulps of it.  config_hash keeps the bound of one ulp, which it meets;
    the NeRF grid (3-D) takes config_btf's with D = 3, 8.3e-7.
  * fused MLP, float32: rtol 1e-5, atol 1e-5; bfloat16: rtol 2e-2,
    atol 2e-3 (a hidden activation may round to the other bf16
    neighbour when the sum is taken in another order).  At config_oneblob's
    six layers such roundings compound: there, and only in bf16, an
    output row beyond the bound passes when
    ``tools.plain_path.rounding_flip_rows`` explains it (the plain version
    with one or two hidden values that lie within 2^-16 of Σ|h·w| of a
    bf16 rounding midpoint rounded the other way lies within the bound of
    that row); each such row is printed.
  * whole model: the bfloat16 MLP tolerance, on O(1) outputs.
  * grid backward (table gradient): per table entry, with S = Σ|w·dy|
    over its updates, |d| <= 2^-11·S, plus one bf16 ulp of ref for bf16
    tables.  Both sides sum in fp32 in an arbitrary order (atomics); n
    terms in two orders differ by at most (n − 1)·2^-24·S, and 2^-11
    covers n up to 8192: a level-0 row takes about 4096 updates at 2^18
    in config_hash, 64 in config_btf.
  * fused-MLP backward: every dW and dx within 1e-4 (fp32) or 2e-2
    (bf16) of its largest magnitude: sums over the batch in another order,
    and in bf16 a dz may round to the other neighbour.  At config_btf
    (four layers, 2^18 samples) a sample's hidden pre-activation may lie
    so near 0 that a bf16 rounding upstream moves it across, which
    switches its ReLU and moves that sample's dx row by a whole term.  So
    there, and only in bf16, a dx row beyond the bound passes when
    ``tools.plain_path.relu_flip_rows`` explains it: the sample has a
    pre-activation with |z| at most 2^-7 of Σ|h·w| (one bf16 ulp of the
    terms), and the plain version recomputed for the outlying samples
    alone, as it is or with the ReLU of one or two of the sample's
    pre-activations nearest 0 flipped, lies within the bound of that row
    in every entry.  The script prints each such sample with its nearest
    |z| / Σ|h·w|.  dW stays within 2e-2 everywhere.
  * training step: the gradients of the step within the MLP-backward
    tolerance of the plain path's on the same tensors.  At config_btf the
    plain path's table gradient is taken from its MLP input gradient with
    the explained rows (above) replaced by their flipped variants.
  * image fit (200 steps at 2^18 on synthetic_image(1024, 1024)): mean
    loss of the last 10 steps below 0.2x the first step's, and PSNR of the
    whole image above 20 dB, the floors of tests/test_trainer.py.
  * BTF fit (200 steps at 2^18 on synthetic_btf): mean loss of the last
    10 steps below 0.05x the first step's, and relL2 on 2^16 held-out
    samples below 0.35; the plain versions' run meets both in 150 steps
    (at 100 it read 0.016x and relL2 0.302 on an H100).  The JAX sample
    (samples/fit_btf.py 200 14 on the CPU, 16x fewer samples a step)
    reached loss 0.246 at step 50 from a first step near 13 (a prediction
    near 0 under RelativeL2), and held-out relL2 0.2518, where a zero
    prediction scores 0.64.
  * grid input gradient (GI) and second order (GG): GI's dx and GG's
    d_dcols and d_x within 1e-5 of their largest magnitude (fp32 sums
    over corners and levels in another order); GG's d_dcols and d_x bit
    for bit in a second launch; GG's table gradient per entry within
    2^-11·S, S the sum of the magnitudes of the terms of its updates,
    Σ_d |∂w_c/∂x_d · ddx_d| · |dcols| (``plain_path.gg_term_magnitudes``:
    Σ|g| is not sound where a g's terms cancel, and missed 2 of 15,474,688
    entries on correct kernels at config_btf), plus one bf16 ulp for bf16
    tables (fp32 atomics in any order, as GB); row scatter-add (RS): per
    entry within 2^-11·S, S = Σ|g| over its updates, plus one bf16 ulp
    for a bf16 result (fp32 atomics in any order).
  * eikonal step: the table gradient per entry within 2^-11·S (S the
    magnitudes of the GB terms and of GG's updates' terms it sums), the
    weights' gradients
    within 1e-4 of their largest magnitude, of the plain eikonal step's.
    A sample whose fp32 pre-activation lies within rounding of 0 may
    switch its ReLU in kernel MB and not in the plain version: its MB dx
    row passes where ``relu_flip_rows`` explains it at 2^-16 of Σ|h·w|,
    and the plain step takes the flipped row (as config_btf in bf16).
  * config_oneblob fit (300 steps at 2^18): mean loss of the last 100
    steps below 0.1, and PSNR above 20 dB; the JAX package's run of the
    same fit (``ONEBLOB_LOSS_FLOOR`` says which) read 0.009874 at step 200
    and 0.006309 at step 300, PSNR 29.68 dB.
  * SDF fit (500 steps at 2^14, the JAX sample's run): mean loss of the
    last 10 steps below 0.05 and mean |sdf error| on 2^14 points in
    [0.2, 0.8]^3 below 0.1.  The JAX sample on the CPU ends at loss
    0.017435 and error 0.0675; an untrained model's loss is about 0.0997,
    and a zero prediction's error 0.0667, so the error floor only guards
    against divergence.

  * NeRF: masked G and GB at the grid bounds above (the plain version
    multiplies the masked pairs' weights by 0, as the JAX package does;
    the kernels skip them: a masked pair's output is an exact 0, and a row
    only masked pairs touch gets no update); M and MB at the MLP bounds,
    bf16 dx rows as config_btf's; the step's gradients within 2e-2 of each
    one's largest magnitude of the plain path's (``plain_nerf_loss_and_grads``).
    The fit: eval PSNR above ``NERF_PSNR_FLOOR``, the JAX sample's CPU run
    at the same settings (fp32) less 3 dB.  The image sample: PSNR above
    20 dB after 100 steps.
  * slice 10, the bindings at config_hash (fp32): the output within the
    fp32 MLP bound, the table gradient per entry within 2^-11·S, the
    weights' gradients within 1e-4 of their largest magnitude, the input
    gradient within 1e-4 of its largest magnitude (it sums kernel MB's dx,
    held within 1e-4), MB dx rows that a switched fp32 ReLU explains taken
    flipped, as in the eikonal step; the eikonal step through the bindings
    at the eikonal step's bounds; the fp16 encoding within one fp16 ulp of
    the plain fp32 output; the pickled module's output bit for bit; the
    image sample's PSNR@1000 at or above ``IMAGE_PT_PSNR_FLOOR``, the JAX
    sample's CPU run at the same settings less 3 dB.
  * slice 9: a restored trainer's next step: the loss and the weights'
    gradients bit for bit (G, M and MB are deterministic), the table
    gradient within GB's bound 2^-11·S; the exported step's and the
    replayed optimizer steps' losses within 1e-3 relative of eager
    ``training_step``s' (as tests/test_torch_cuda.py's graph loop), their
    step counters and ExponentialDecay's factor equal, but for a lazy
    counter's entries whose recorded gradients differ between the runs
    (GB's atomics), where each run's counter is the count its own
    gradients give (``tools/replay_check.py``); one optimizer
    step on the card against the CPU's: step counters equal, every float
    leaf within rtol 1e-5 plus 1e-6 of its largest magnitude (fp32
    elementwise operations; the CPU tests' bound against JAX), Shampoo
    rtol 1e-4 plus 1e-5 (matrix products in fp32; the step compared is
    t = 3, no refresh).  Shampoo's roots refreshed at t = 10 (kernel SR)
    against the float64 roots of the same float32 S within ``ROOT_TOL``,
    32 ulps of the root's largest entry (SR diagonalises in fp64 and
    rounds once).  Served requests against the plain path: the
    whole-model bf16 tolerance.

  * slice 11: the grid kernels at the bounds above (GI, GG's d_dcols and
    d_x within 1e-5 of each output's largest magnitude, GB and GG's table
    gradient per entry within 2^-11·S);
    a stochastic level's gradient sums to its cotangents' sum (1e-5 of
    Σ|dy|); the eikonal steps' losses at 1e-4 relative and gradients
    within 1e-4 of each largest magnitude; MB 128 x 12 in fp32 at the MB
    bounds, in bf16 dW within 2e-2 of each largest magnitude and dx
    within 2e-2 in relative L2 norm (over twelve layers a hidden value
    that rounds the other way, or a ReLU it switches, moves whole rows
    beyond what ``relu_flip_rows`` explains); jvp's output at the fp32
    MLP bound and its tangent, and jacrev, within 1e-4 of their largest
    magnitude (fp32 sums over corners, levels and samples in another
    order).

  * slice 14: GT's d_dcols and d_x within 1e-5 of each one's largest
    magnitude and bit for bit in a second launch (bf16 tables and
    cotangents are read as the plain version reads them), its table
    gradient per
    entry within 2^-11·S over its updates' terms (``plain_path.
    gt_table_scale``; one bf16 ulp more for a bf16 table), as GG's; the
    stochastic gather at G's bounds (it
    meets the plain version's bits: one corner at weight 1); the curvature
    step's loss at 1e-4 relative and every gradient, the table's too,
    within 1e-4 of its largest magnitude (the third order's per-entry term
    magnitudes are not formed); the curvature fit's mean of the last 10
    losses below ``CURVATURE_LOSS_FLOOR``; M at 64 x 40 bit for bit against
    a chain of shallow launches, in fp32 also at the fp32 MLP bound, MB at
    the fp32 bounds of MB 128 x 12, in bf16 bit for bit against launches
    over runs of five layers (bf16 roundings of dz compound over 41 layers:
    the plain version's dW lay 5 % apart in relative L2 norm at 33 layers
    in the card tests); the prefetched fit's PSNR within
    ``PREFETCH_PSNR_MARGIN`` of the on-device sampler's fit.

  * slice 16: the wide SDF's curvature step is checked with Softplus hidden
    layers at the slice-14 bounds: with ReLU, a sample whose pre-activation
    lies within fp32 rounding of 0 switches in one path and not the other,
    and in the curvature term at 2^18 one such switch moved a table entry
    by 0.604, 2.6 % of the largest (on an H100).
  * slice 16: the wide SDF's eikonal step holds its table gradient within
    1e-4 of its largest magnitude, as the curvature step does: 29 and 73
    of its 74,607,488 entries lay beyond 2^-11·S in two runs on an H100.
    It prints how many lie beyond that bound, and how many when the plain
    step runs on kernel MB's dx (``kernel_dx_bwd``): the per-entry bound
    holds where both paths share the grid's output gradient, and MB's dx,
    within its own bound, may cancel to a few ulps of its terms in a
    sample.
  * slice 16: the grid kernels at F = 16 and 32 at the bounds above (G at
    the grid bounds, GB and the table gradients of GG and GT per entry
    within 2^-11·S, GI and GG's and GT's d_dcols and d_x within 1e-5 of
    each one's largest magnitude and bit for bit in a second launch); M
    and MB at the MLP bounds (dx rows of switched ReLUs aside in bf16), the
    streamed-layer instances too (they sum over the input features in
    chunks of 32, in another order than the plain version: n terms in two
    orders differ by at most (n − 1)·2^-24·Σ|x·w|, the bound the fp32
    tolerances stand in for), their dW bit for bit in a second launch; the wide SDF's steps at the eikonal
    and curvature steps' bounds; the fit's mean of the last 10 losses below
    ``WIDE_FIT_LOSS_FLOOR``; the wide image's step at the step bounds.

  * slice 21: the compiled steps under ``sortseg`` bit for bit (losses and
    weights); without it the losses as slice 18's loop (the first within
    ``PARALLEL_FIRST_RTOL``, the rest ``PARALLEL_LOSS_RTOL``); a replayed
    SDF step against an eager one at the eikonal step's bounds, a NeRF
    step at the NeRF step's (loss 2e-2 relative, gradients 2e-2 of each
    one's largest magnitude); the SDF fit's mean of the last 10 losses
    within a factor ``SDF_FIT_LOSS_FACTOR`` of the CPU fit's 0.019 and its
    error within ``SDF_FIT_ERROR_ATOL`` of 0.067; the NeRF fit's PSNR
    within ``NERF_PSNR_ATOL`` of the eager fit's 37.03 dB.

  * slice 22: requests, the layers' steps under ``sortseg`` and their
    requests bit for bit; DataParallel's compiled steps without it as slice
    18's loop (the first loss within ``PARALLEL_FIRST_RTOL``, the rest
    ``PARALLEL_LOSS_RTOL`` of ``Trainer.make_training_step``'s).

  * slice 12: each shard's G at the fp32 bound with the fp32 sum's own
    error (its partial features are fp32: |d| <= 1e-5·|ref| + (2^D +
    2D)·2^-24), GB, GI and GG at the grid bounds above; the shards' G
    partials summed (and rounded once to the table's dtype) against the
    unsharded G at the grid bounds with n times that sum error; GI's
    partials summed within 1e-5 of the largest magnitude; the shards' GB
    per entry within 2^-11·S of the unsharded GB's block-cyclic slices.
    Two ranks against one process: ``PARALLEL_FIRST_RTOL``,
    ``PARALLEL_LOSS_RTOL`` and ``PARALLEL_PRED_REL`` (their comment says
    why).

The whole run takes about four minutes on an H100, against the 1200 s a
run may take: the build of the seven kernels took 93 to 155 s, the
plain versions' BTF fit, 150 eager steps (the kernels' fit runs 200), 30
to 45 s, the NeRF fit 4 to 5 s, the slice-9 phase about 15 s, the
slice-10 phase (which prints its own time) about 8 s, slice 11 about
three minutes (MB 128 x 12 in fp32 most of it); the whole 196.5 to 245 s
with a 96 to 129 s build before slice 11 (H100 80GB HBM3, 700 W); with
slice 16, whose phase took 42.1 s, 400.3 s with a 127.6 s build.  It
prints its own time before the kernels' line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = "configs/config_hash.json"
BTF_CONFIG = "configs/config_btf.json"
BTF_GRID_PARAMS = 15474688
MAIN_BATCH = 1 << 18
FIT_STEPS = 200
LOOP_STEPS = 100     # the timed make_training_loop call
REQUESTS = (1 << 18, 1 << 16, 12345, 1)
N_TIMED = 30
PLAIN_BTF_STEPS = 150   # the plain versions' BTF fit: reaches the floors with margin
BTF_LOSS_RATIO = 0.05
BTF_REL_FLOOR = 0.35
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, fp32 FLOP/s outside the tensor cores (the FMA units).
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
UNIT = {PEAK_BF16: "bf16 tensor cores", PEAK_FP32: "fp32 FMA"}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name):
    print(f"== {name}", flush=True)


def bf16_ulp(t):
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def compare(got, want, kind, atol=0.0):
    """(max abs err, max rel err); raises beyond the stated tolerance
    (``atol``: the fp32 sum's own error added to the grid-bf16 bound)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{kind}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{kind}: non-finite output")
    err = (g - w).abs()
    if kind == "grid-bf16":
        bad = err > bf16_ulp(w) + atol
    elif kind == "grid-f32":
        bad = err > 1e-5 * w.abs() + 1e-6
    elif kind == "mlp-f32":
        bad = err > 1e-5 * w.abs() + 1e-5
    else:  # mlp-bf16, model
        bad = err > 2e-2 * w.abs() + 2e-3
    rel = (err / w.abs().clamp_min(1e-6)).max().item()
    check(not bool(bad.any()), f"{kind}: {int(bad.sum())} elements beyond "
          f"tolerance, max abs err {err.max().item():.3e}")
    return err.max().item(), rel


def time_ms(fn, n=N_TIMED, warmup=5):
    """Median time of one call of fn(), host work included: CUDA events
    around each call, n calls after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def eager_ms(fn, n=10, reps=3):
    """Time per call of n back-to-back calls between two CUDA events,
    median of reps (for work that cannot be captured in a graph)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def graph_ms(fn, n=N_TIMED, reps=5):
    """Device time per call: n calls captured in one CUDA graph, replayed
    reps times between CUDA events (no host work inside), median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def touched_bytes(spec, x, elem, shard=None):
    """The bytes of the table rows that the batch x touches (all levels; of
    the shard's rows with ``shard``)."""
    from tcnn_tpu_torch.ops import grid_ops

    idx, _ = grid_ops.build_indices_weights(spec, x, list(range(spec.n_levels)), shard=shard)
    idx = idx.reshape(-1)
    touched = torch.zeros(spec.n_entries // (shard[1] if shard else 1), dtype=torch.bool,
                          device=x.device)
    touched[idx[idx >= 0]] = True
    return int(touched.sum()) * spec.n_features_per_level * elem


def bound_by(n_bytes, flops, peak):
    return "bytes" if n_bytes / PEAK_BYTES >= flops / peak else "operations"


def bound_ms(n_bytes, flops, peak):
    """Least time for the work: bytes over HBM or operations over peak."""
    return max(n_bytes / PEAK_BYTES, flops / peak) * 1e3


def grid_flops(spec, batch):
    """Per (sample, level): x·scale + 0.5 and fract (3D), 1 − w (D), corner
    weights C(D − 1), weighted sum 2CF (GB: w·dy and the add, also 2CF)."""
    L, F, D, C = spec.n_levels, spec.n_features_per_level, spec.n_dims, 1 << spec.n_dims
    return batch * L * (4 * D + C * (D - 1) + 2 * C * F)


def compare_table_grad(got, want, scale, what="table grad"):
    """Max abs error of a table gradient or a row scatter-add (fp32 sums in
    any order); raises beyond 2^-11·S (+ one bf16 ulp for bf16 tables),
    S per entry the sum of the magnitudes of its terms (Σ|w·dy|, Σ|g|)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite values")
    err = (g - w).abs()
    tol = 2.0 ** -11 * scale + 1e-30
    if want.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(w)
    bad = err > tol
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} entries beyond "
          f"tolerance, max abs err {err.max().item():.3e}")
    return err.max().item()


def compare_mlp_grads(got, want, dtype, what):
    """Max abs error over a list of gradients; raises beyond 1e-4 (fp32)
    or 2e-2 (bf16) of each gradient's largest magnitude."""
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape, f"{what}[{i}]: {tuple(a.shape)} vs {tuple(b.shape)}")
        check(bool(torch.isfinite(a.float()).all()), f"{what}[{i}]: non-finite values")
        err = (a.float() - b.float()).abs().max().item()
        lim = rel * b.float().abs().max().item()
        check(err <= lim, f"{what}[{i}]: max abs err {err:.3e} beyond {lim:.3e}")
        worst = max(worst, err)
    return worst


MAX_FLIP_ROWS = 1024   # more rows beyond the bound than switched ReLUs make


def compare_input_grad(got, want, ws, x, g, out_act, soa_in=False, soa_out=False,
                       what="dx", dtype=torch.bfloat16):
    """An MLP input gradient in bf16 (or fp32) against the plain version's,
    one row per sample: within 2e-2 (1e-4) of its largest magnitude, but
    for rows that ``relu_flip_rows`` explains (a pre-activation lies within
    rounding of 0: 2^-7 (2^-16) of Σ|h·w|, and the plain version recomputed
    for these rows, with one or two ReLUs nearest 0 flipped or none, lies
    within that bound).  x and g are the plain version's MLP input and
    output gradient.  Returns (max abs err over the other rows, the
    explained rows' sample indices, their flipped variants in the rows'
    layout)."""
    from tcnn_tpu_torch.tools.plain_path import relu_flip_rows

    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    check(got.shape == want.shape, f"{what}: {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite values")
    a, b = (got.t(), want.t()) if soa_in else (got, want)
    err = (a.float() - b.float()).abs()
    tol = rel * b.float().abs().max().item()
    rows = (err > tol).any(dim=1).nonzero().flatten()
    check(rows.numel() <= MAX_FLIP_ROWS, f"{what}: {rows.numel()} rows beyond {tol:.3e}")
    other = err.max(dim=1).values
    other[rows] = 0
    if not rows.numel():
        return other.max().item(), rows, a[rows].float()
    explained, variants, flipped, nearest = relu_flip_rows(
        ws, x, g, out_act, dtype, rows, a[rows], tol, soa_in, soa_out)
    for r, s, e, f, z in zip(range(10), rows.tolist(), err[rows].max(dim=1).values.tolist(),
                             flipped.tolist(), nearest.tolist()):
        fs = [f"{v:.3e}" for v in f if v == v]
        how = ("no flipped ReLU explains it" if not bool(explained[r]) else
               f"the plain row with the ReLU(s) at {', '.join(fs)} flipped matches it" if fs
               else "the plain row recomputed for these samples alone matches it")
        print(f"{what}: sample {s} off by {e / tol * rel:.3e} of the largest magnitude; "
              f"its pre-activation nearest 0 at |z| / Σ|h·w| = {z:.3e}; {how}")
    check(bool(explained.all()), f"{what}: {int((~explained).sum())} of {rows.numel()} "
          f"rows beyond {tol:.3e} not explained by a switched ReLU")
    print(f"{what}: {rows.numel()} of {a.shape[0]} rows beyond {rel:g} of the largest "
          f"magnitude, each explained by a switched ReLU")
    return other.max().item(), rows, variants


def check_step_gradients(model, x, target, flips=False):
    """The trainer's loss and gradients against the plain path's.  With
    ``flips`` (config_btf, bf16), the rows of the MLP input gradient that
    a switched ReLU explains take their flipped variants before the plain
    path's table gradient is formed from it."""
    from tcnn_tpu_torch.tools.plain_path import plain_grid_grads, plain_step_parts

    loss, grads = model.trainer.loss_value_and_grads(x, target)
    p = plain_step_parts(model, x, target)
    dfeats = p.dfeats
    if flips:
        net = model.network.network
        # the kernel path's MLP input gradient on the same tensors (G, M, MB)
        feats = model.network.encoding(x).detach().requires_grad_()
        (got,) = torch.autograd.grad(model.loss(net(feats).float(), target), feats)
        _, rows, variants = compare_input_grad(
            got.t() if p.soa else got, dfeats, [w.detach() for w in net.layers], p.feats,
            p.dy, net.output_activation, soa_in=p.soa, what="step dx")
        dfeats = dfeats.clone()
        (dfeats.t() if p.soa else dfeats)[rows] = variants.to(dfeats.dtype)
    want_grads = plain_grid_grads(model, x, dfeats, p.soa)
    want_grads.update({f"network.layers.{i}": d for i, d in enumerate(p.dws)})
    want_loss = p.loss
    torch.cuda.synchronize()
    check(abs(loss.item() - want_loss.item()) <= 2e-2 * abs(want_loss.item()),
          f"step loss {loss.item()} vs plain {want_loss.item()}")
    check(set(grads) == set(want_grads), f"gradient names {sorted(grads)}")
    for name in grads:
        check(grads[name].dtype == torch.float32, f"{name}: gradient dtype {grads[name].dtype}")
        err = compare_mlp_grads([grads[name]], [want_grads[name]], torch.bfloat16, name)
        print(f"gradient {name}: max abs err {err:.3e} vs plain path "
              f"(max |g| {want_grads[name].abs().max().item():.3e}, 2e-2 of it)")
    print(f"loss {loss.item():.6f}, plain path {want_loss.item():.6f}")
    return grads


def random_mlp(gen, dev, dims):
    return [(torch.rand(d, generator=gen, device=dev) * 2 - 1)
            * float(np.sqrt(6.0 / sum(d))) for d in dims]


def mlp_dims(d_in, width, n_hidden, d_out=3):
    return [(d_in, width)] + [(width, width)] * (n_hidden - 1) + [(width, d_out)]


def compare_mlp_rows(got, want, ws, x, soa_in, what):
    """A bf16 MLP output against the plain version's, at the mlp-bf16
    bound, but for rows that another correct rounding explains: over five
    or more bf16 layers a hidden value that lies on a rounding boundary
    rounds either way in two correct sums, and the whole row moves.  Such
    a row passes when ``tools.plain_path.rounding_flip_rows`` finds the
    plain version, with one or two hidden values within 2^-16 of Σ|h·w| of
    a rounding midpoint rounded the other way, within the bound of that
    row in every entry; each is printed.  Returns (max abs err, max rel
    err) over the other rows."""
    from tcnn_tpu_torch.tools.plain_path import rounding_flip_rows

    check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shapes")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    tol = 2e-2 * w.abs() + 2e-3
    rows = (err > tol).any(dim=1).nonzero().flatten()
    check(rows.numel() <= MAX_FLIP_ROWS, f"{what}: {rows.numel()} rows beyond the bound")
    if rows.numel():
        explained, nearest = rounding_flip_rows(ws, x, rows, g[rows], tol[rows], soa_in)
        for s, r in enumerate(rows.tolist()[:10]):
            print(f"{what}: sample {r} off by {(err[r] / tol[r]).max().item():.3f} of its bound; "
                  f"its hidden value nearest a bf16 rounding midpoint at {nearest[s].item():.3e} "
                  f"of Σ|h·w|; {'explained' if bool(explained[s]) else 'not explained'} by "
                  f"another rounding")
        check(bool(explained.all()), f"{what}: {int((~explained).sum())} of {rows.numel()} "
              f"rows beyond the bound not explained by another rounding")
        print(f"{what}: {rows.numel()} of {g.shape[0]} rows beyond the bound, each explained "
              f"by another rounding")
        err[rows] = 0
    return err.max().item(), (err / w.abs().clamp_min(1e-6)).max().item()


def mlp_case(gen, dev, dims, batch, dtype, soa_in=True, soa_out=False, rounding=False,
             out_act=None):
    """Kernel M against its plain version; returns the max abs error.  With
    ``rounding`` (config_oneblob's six layers) a bf16 row beyond the bound
    passes where the plain version's rounding explains it
    (``compare_mlp_rows``).  ``out_act``: the output activation (None)."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_fwd, fused_mlp_plain

    ws = random_mlp(gen, dev, dims)
    d_in = dims[0][0]
    x = torch.rand((d_in, batch) if soa_in else (batch, d_in), generator=gen,
                   device=dev) * 2 - 1
    args = (ws, x.to(dtype), Activation.RELU, out_act or Activation.NONE, dtype,
            torch.float32, soa_in, soa_out)
    with torch.inference_mode():
        got = fused_mlp_fwd(*args)
        torch.cuda.synchronize()
        want = fused_mlp_plain(*args)
    if rounding and dtype == torch.bfloat16 and not soa_out:
        abs_err, rel_err = compare_mlp_rows(got, want, ws, args[1], soa_in, "M")
    else:
        abs_err, rel_err = compare(got, want,
                                   "mlp-bf16" if dtype == torch.bfloat16 else "mlp-f32")
    print(f"{d_in} -> {dims[0][1]} x {len(dims) - 1} -> {dims[-1][1]} B={batch} "
          f"{str(dtype)[6:]} in={'SoA' if soa_in else 'AoS'} "
          f"out={'SoA' if soa_out else 'AoS'}: max abs err {abs_err:.3e}, "
          f"max rel err {rel_err:.3e}")
    return abs_err


def mlp_bwd_case(gen, dev, dims, batch, dtype, soa_in=True, soa_out=False, flips=False,
                 out_act=None):
    """Kernel MB against its plain version; returns the max abs error.
    With ``flips`` (config_btf) a bf16 dx row beyond the bound passes where
    a switched ReLU explains it (``compare_input_grad``)."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd, fused_mlp_bwd_plain

    ws = random_mlp(gen, dev, dims)
    d_in, d_out = dims[0][0], dims[-1][1]
    out_act = out_act or Activation.NONE
    x = torch.rand((d_in, batch) if soa_in else (batch, d_in), generator=gen,
                   device=dev) * 2 - 1
    g = torch.randn((d_out, batch) if soa_out else (batch, d_out), generator=gen, device=dev)
    args = (ws, x.to(dtype), g, Activation.RELU, out_act, dtype, soa_in, soa_out)
    with torch.inference_mode():
        got_dws, got_dx = fused_mlp_bwd(*args)
        torch.cuda.synchronize()
        want_dws, want_dx = fused_mlp_bwd_plain(*args)
    check(got_dx.dtype == dtype, f"MB: dx dtype {got_dx.dtype}")
    if flips and dtype == torch.bfloat16:
        err = max(compare_mlp_grads(got_dws, want_dws, dtype, "MB"),
                  compare_input_grad(got_dx, want_dx, ws, args[1], g, out_act,
                                     soa_in, soa_out, "MB dx")[0])
    else:
        err = compare_mlp_grads([*got_dws, got_dx], [*want_dws, want_dx], dtype, "MB")
    print(f"{d_in} -> {dims[0][1]} x {len(dims) - 1} -> {dims[-1][1]} B={batch} "
          f"{str(dtype)[6:]} in={'SoA' if soa_in else 'AoS'} "
          f"out={'SoA' if soa_out else 'AoS'}: max abs err {err:.3e} over dW and dx "
          f"({'2e-2' if dtype == torch.bfloat16 else '1e-4'} of each max"
          f"{', dx rows of switched ReLUs aside' if flips and dtype == torch.bfloat16 else ''})")
    return err


def grid_bwd_case(spec, table, x, dc, label):
    """Kernel GB against its plain version; returns the max abs error."""
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd, grid_encode_bwd_plain

    live = list(range(spec.n_levels))
    with torch.inference_mode():
        got = grid_encode_bwd(spec, table, x, dc, live)
        torch.cuda.synchronize()
        want = grid_encode_bwd_plain(spec, table, x, dc, live)
        scale = grid_encode_bwd_plain(spec, table.float(), x, dc.float().abs(), live)
    abs_err = compare_table_grad(got, want, scale)
    bf16 = table.dtype == torch.bfloat16
    print(f"{label} table={str(table.dtype)[6:]}: max abs err {abs_err:.3e} "
          f"(2^-11·S{' + one bf16 ulp' if bf16 else ''})")
    return abs_err


def counters():
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_fwd,
                                                   fused_mlp_wide_bwd, fused_mlp_wide_fwd)
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd, grid_encode_bwd_bwd,
                                                     grid_encode_bwd_input, grid_encode_fwd,
                                                     grid_encode_third)
    from tcnn_tpu_torch.ops.cuda.scatter import row_scatter_add

    return {"G": grid_encode_fwd, "M": fused_mlp_fwd, "GB": grid_encode_bwd,
            "MB": fused_mlp_bwd, "GI": grid_encode_bwd_input, "GG": grid_encode_bwd_bwd,
            "RS": row_scatter_add, "GT": grid_encode_third, "MW": fused_mlp_wide_fwd,
            "MBW": fused_mlp_wide_bwd}


FIRST_ORDER = ("G", "M", "GB", "MB")


def first_order_counts():
    """The counts of the first-order kernels, with a check that the
    second- and third-order kernels GI, GG, RS and GT, and the
    streamed-layer instances of M and MB, were not launched."""
    c = counts()
    check(all(c[k] == 0 for k in ("GI", "GG", "RS", "GT", "MW", "MBW")),
          f"a first-order path launched a second-order kernel: {c}")
    check(all(fn.launches == 0 for fn in sortseg_counters().values()),
          "a path without TCNN_TPU_SCATTER=sortseg launched kernel SK or SS")
    return {k: c[k] for k in FIRST_ORDER}


def reset_counts():
    for fn in (*counters().values(), *sortseg_counters().values(),
               *shampoo_counters().values()):
        fn.launches = 0


def counts():
    return {k: fn.launches for k, fn in counters().items()}


def chain_activations(ws, h):
    """The inputs of each layer of a ReLU MLP chain, from its input h."""
    hs = [h]
    for w in ws[:-1]:
        hs.append(torch.relu(hs[-1] @ w))
    return hs


def library_chain(ws, h, out=None):
    """The MLP's forward as cuBLAS products (and ``out``, the output
    activation), timed only as a yardstick."""
    for w in ws[:-1]:
        h = torch.relu(h @ w)
    return h @ ws[-1] if out is None else out(h @ ws[-1])


def library_bwd(ws, hs, dy):
    """The chain's backward on its saved activations ``hs``, as cuBLAS
    products, timed only as a yardstick."""
    dz, dws = dy.to(ws[0].dtype), []
    for i in range(len(ws) - 1, -1, -1):
        dws.append(hs[i].t() @ dz)
        dz = dz @ ws[i].t()
        if i:
            dz = dz * (hs[i] > 0)
    return dws, dz


LIBRARY = {"M": "cuBLAS chain", "MB": "cuBLAS chain backward", "RS": "index_add_"}


def record_bounds(t, b, notes=None):
    """Each kernel's bound from ``b`` (name: bytes moved, operations, peak
    of their type) into ``t``, printed beside the kernel's times in ``t``:
    device time, with the host's work where measured, plain version and
    library call."""
    for k, (n_bytes, flops, peak) in b.items():
        t[f"{k} bound"] = bound_ms(n_bytes, flops, peak)
        t[f"{k} bound by"] = bound_by(n_bytes, flops, peak)
        call = (f", {t[k + ' call']:.4f} ms per call with the host's work"
                if k + " call" in t else "")
        lib = f", {LIBRARY[k]} {t[k + ' library']:.4f} ms" if k + " library" in t else ""
        print(f"{k}: {t[k]:.4f} ms on the device{call} (plain {t[k + ' plain']:.4f} ms{lib}, "
              f"bound {t[k + ' bound']:.4f} ms: {n_bytes / 1e6:.2f} MB"
              f"{(notes or {}).get(k, '')}, {flops / 1e9:.3f} GFLOP on the {UNIT[peak]})")


def slice_times(label, model, x, target, loop):
    """Times at the model's shapes on the batch (x, target): kernels G, M,
    MB and GB on the tensors the model hands them (device time in a CUDA
    graph, per call with the host's work, plain versions eager, cuBLAS
    yardsticks), a request, the step's parts, the step and ``loop()``;
    and each kernel's bound, in the model's compute dtype (bf16 or fp32:
    M and MB on the tensor cores or the FMA units).  Prints them and
    returns them by name."""
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_fwd, fused_mlp_plain)
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd,
                                                     grid_encode_bwd_plain,
                                                     grid_encode_fwd,
                                                     grid_encode_plain)
    from tcnn_tpu_torch.tools.plain_path import grid_parts

    phase(f"{label} times at B={MAIN_BATCH}: kernels, library calls and whole steps as "
          f"device time in a CUDA graph of {N_TIMED} calls; plain versions eager")
    (_, grid, xg, col), = grid_parts(model, x)
    enc, net, spec = model.network.encoding, model.network.network, grid.spec
    soa = enc is grid   # a grid alone hands the MLP SoA features
    others = [e for e in getattr(enc, "nested", ()) if e is not grid]
    live = list(range(spec.n_levels))
    cdt, relu, out_act = model.network.policy.compute_dtype, net.activation, net.output_activation
    mlp_peak = PEAK_BF16 if cdt == torch.bfloat16 else PEAK_FP32
    table = grid.grid.detach().to(cdt)
    ws = [w.detach().to(cdt) for w in net.layers]
    t = {}
    with torch.inference_mode():
        feats = enc(x, soa=True) if soa else enc(x)   # the MLP's input
        gfeats = grid_encode_fwd(spec, table, xg, live, soa=soa)
        mlp_args = (ws, feats, relu, out_act, cdt, torch.float32, soa, False)
        f_in = feats.t() if soa else feats

        def g_call():
            return grid_encode_fwd(spec, table, xg, live, soa=soa)

        def m_call():
            return fused_mlp_fwd(*mlp_args)

        def request():
            return model.trainer.inference(x)

        t["G"], t["G call"] = graph_ms(g_call), time_ms(g_call)
        t["G plain"] = eager_ms(lambda: grid_encode_plain(spec, table, xg, live, soa=soa))
        t["M"], t["M call"] = graph_ms(m_call), time_ms(m_call)
        t["M plain"] = eager_ms(lambda: fused_mlp_plain(*mlp_args))
        t["M library"] = graph_ms(lambda: library_chain(ws, f_in))
        t["request device"], t["request"] = graph_ms(request), time_ms(request)
        if grid.grid.dtype != cdt:   # where the dtypes match the copy is no work
            t["table copy"] = graph_ms(lambda: grid.grid.detach().to(cdt))
        t["other encodings"] = sum(graph_ms(lambda e=e, b=b, nd=nd: e(x[:, b:b + nd]))
                                   for e, (b, nd) in zip(getattr(enc, "nested", ()),
                                                         getattr(enc, "slices", ()))
                                   if e is not grid)
        # the table rows this batch touches: the table bytes G must read
        g_table_bytes = touched_bytes(spec, xg, table.element_size())

    # The training step's parts on the same batch: the loss and its
    # gradient, MB on that gradient, GB on MB's input gradient, Adam.
    with torch.no_grad():
        pred = fused_mlp_fwd(*mlp_args)

    def loss_call():
        p = pred.detach().requires_grad_()
        return torch.autograd.grad(model.loss(p, target), p)[0]

    dy = loss_call()
    with torch.inference_mode():
        mb_args = (ws, feats, dy, relu, out_act, cdt, soa, False)
        dfeats = fused_mlp_bwd(*mb_args)[1]
        cols = slice(col, col + spec.n_output_dims)
        dcols = dfeats[cols] if soa else dfeats[:, cols].t()
        hs = chain_activations(ws, f_in)

        def mb_call():
            return fused_mlp_bwd(*mb_args)

        def gb_call():
            return grid_encode_bwd(spec, table, xg, dcols, live)

        t["MB"], t["MB call"] = graph_ms(mb_call), time_ms(mb_call)
        t["MB plain"] = eager_ms(lambda: fused_mlp_bwd_plain(*mb_args))
        t["MB library"] = graph_ms(lambda: library_bwd(ws, hs, dy))
        t["GB"], t["GB call"] = graph_ms(gb_call), time_ms(gb_call)
        t["GB plain"] = eager_ms(lambda: grid_encode_bwd_plain(spec, table, xg, dcols, live))

    trainer = model.trainer
    _, step_grads = trainer.loss_value_and_grads(x, target)
    t["loss"] = graph_ms(loss_call)
    t["Adam"] = graph_ms(lambda: model.optimizer.step(trainer.opt_state, step_grads,
                                                      trainer.params()))
    t["step"] = time_ms(lambda: trainer.training_step(x, target))
    t["step device"] = graph_ms(lambda: trainer.training_step(x, target))
    loop_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop_losses = loop()
        torch.cuda.synchronize()
        loop_times.append((time.perf_counter() - t0) * 1e3 / LOOP_STEPS)
    check(bool(torch.isfinite(loop_losses).all()), "non-finite loss in the timed loop")
    t["loop step"] = float(np.median(loop_times))

    # Least time for the same work: each input read once (the x columns
    # the grid reads, the table rows this batch touches), each output
    # written once, over HBM; operations over the peak of their type.
    consts_bytes = spec.n_levels * grid_ops.LEVEL_FIELDS * 4
    b = {"G": (nbytes(xg, gfeats) + g_table_bytes + consts_bytes,
               grid_flops(spec, MAIN_BATCH), PEAK_FP32)}
    m_flops = 2 * MAIN_BATCH * sum(w.numel() for w in ws)
    b["M"] = (nbytes(feats, *ws) + MAIN_BATCH * net.n_output_dims * 4, m_flops, mlp_peak)
    # GB: x, dcols and the level constants in, the bf16 table gradient out.
    b["GB"] = (nbytes(xg, dcols, table) + consts_bytes, b["G"][1], PEAK_FP32)
    # MB: input, output gradient and weights in; input gradient and fp32 dW
    # out.  Products: the recomputed forward, the dgrad and the wgrad chains.
    b["MB"] = (nbytes(feats, dy, *ws, dfeats) + sum(w.numel() for w in ws) * 4,
               3 * m_flops, mlp_peak)
    record_bounds(t, b, {"G": f" with {g_table_bytes / 1e6:.2f} MB of touched table rows"})
    parts = {k: t[k] for k in ("G", "M", "table copy") if k in t}
    if others:
        parts["other encodings"] = t["other encodings"]
    print(f"inference at B={MAIN_BATCH}: {t['request']:.4f} ms per request, "
          f"{MAIN_BATCH / t['request'] * 1e3:.4e} samples/s; {t['request device']:.4f} ms "
          f"of device work (idle share {1 - t['request device'] / t['request']:.3f}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f", the rest {t['request device'] - sum(parts.values()):.4f} ms")
    parts.update({k: t[k] for k in ("loss", "MB", "GB", "Adam")})
    parts["casts, gaps and the rest"] = t["step device"] - sum(parts.values())
    print(f"training step at B={MAIN_BATCH}: {t['step']:.4f} ms eager with the host's "
          f"work, {t['step device']:.4f} ms of device work (idle share "
          f"{1 - t['step device'] / t['step']:.3f}); split: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    print(f"make_training_loop at B={MAIN_BATCH}: {t['loop step']:.4f} ms per step "
          f"(median of 3 calls of {LOOP_STEPS} steps), "
          f"{MAIN_BATCH / t['loop step'] * 1e3:.4e} training samples/s, idle share "
          f"{1 - t['step device'] / t['loop step']:.3f}")
    return t


KERNELS = {   # timing key: (report name, source)
    "G": ("grid_encode_fwd", "tcnn_tpu_torch/csrc/grid_encode.cu"),
    "M": ("fused_mlp_fwd", "tcnn_tpu_torch/csrc/fused_mlp.cu"),
    "GB": ("grid_encode_bwd", "tcnn_tpu_torch/csrc/grid_encode_bwd.cu"),
    "MB": ("fused_mlp_bwd", "tcnn_tpu_torch/csrc/fused_mlp_bwd.cu"),
    "GI": ("grid_encode_bwd_input", "tcnn_tpu_torch/csrc/grid_encode_bwd_input.cu"),
    "GG": ("grid_encode_bwd_bwd", "tcnn_tpu_torch/csrc/grid_encode_bwd_bwd.cu"),
    "RS": ("row_scatter", "tcnn_tpu_torch/csrc/row_scatter.cu"),
    "GT": ("grid_encode_third", "tcnn_tpu_torch/csrc/grid_encode_third.cu"),
    "MW": ("fused_mlp_wide_fwd", "tcnn_tpu_torch/csrc/fused_mlp_wide.cu"),
    "MBW": ("fused_mlp_wide_bwd", "tcnn_tpu_torch/csrc/fused_mlp_wide.cu"),
}


def report_entries(suffix, t, replaces, launches, errors, extra=None):
    """The {"kernels": [...]} entries of one path, one per kernel in
    ``replaces`` (timing key: the TPU kernel it replaces): launches from
    its main path's run, numbers from its timing (``slice_times``,
    ``sdf_slice``), and each field of ``extra`` (field: {key: value})."""
    out = []
    for k, replaced in replaces.items():
        name, source = KERNELS[k]
        entry = {"name": name + suffix, "route": "cuda", "source": source,
                 "replaces": replaced, "launches": launches[k],
                 "max_abs_err": errors[k], "ms": t[k], "plain_ms": t[k + " plain"],
                 "bound_ms": t[k + " bound"], "bound_by": t[k + " bound by"],
                 "library_ms": t.get(k + " library")}
        entry.update({field: v[k] for field, v in (extra or {}).items() if k in v})
        out.append(entry)
    return out


def config_hash_slices(gen, dev):
    """Slices 1 and 2 on config_hash; returns the kernels' report entries."""
    from tcnn_tpu_torch import BF16_POLICY, DEFAULT_POLICY, create_from_config
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_fwd
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_fwd, grid_encode_plain
    from tcnn_tpu_torch.tools.plain_path import plain_inference, plain_training_step
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image
    from tcnn_tpu_torch.utils.metrics import psnr

    # The main path's model: config_hash at full width.  A trained table
    # holds O(1) features; the U(±1e-4) init would put every error below
    # any tolerance, so the table is redrawn U(±1) from the seed.
    model = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    enc = model.network.encoding
    with torch.no_grad():
        enc.grid.uniform_(-1, 1, generator=gen)
    spec = enc.spec
    live = list(range(spec.n_levels))

    phase("grid encode (G) vs plain, config_hash geometry")
    g_err = 0.0
    for batch in (MAIN_BATCH, MAIN_BATCH - 37):
        x = torch.rand((batch, 2), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            table = enc.grid.detach().to(dtype)
            for soa in (True, False):
                with torch.inference_mode():
                    got = grid_encode_fwd(spec, table, x, live, soa=soa)
                    torch.cuda.synchronize()
                    want = grid_encode_plain(spec, table, x, live, soa=soa)
                kind_ = "grid-bf16" if dtype == torch.bfloat16 else "grid-f32"
                abs_err, rel_err = compare(got, want, kind_)
                g_err = max(g_err, abs_err)
                print(f"B={batch} table={str(dtype)[6:]} {'SoA' if soa else 'AoS'}: "
                      f"max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
                      f"({'one bf16 ulp' if dtype == torch.bfloat16 else 'rtol 1e-5, atol 1e-6'})")

    phase("fused MLP (M) vs plain")
    m_err = 0.0
    for batch in (MAIN_BATCH, MAIN_BATCH - 37):
        for dtype in (torch.bfloat16, torch.float32):
            err = mlp_case(gen, dev, mlp_dims(32, 64, 2), batch, dtype)
            if dtype == torch.bfloat16:
                m_err = max(m_err, err)
    for width in (16, 32, 128):
        for dtype in (torch.bfloat16, torch.float32):
            mlp_case(gen, dev, mlp_dims(32, width, 2), 4133, dtype, soa_in=False,
                     soa_out=True)

    phase("slice: config_hash requests through model.trainer.inference (BF16_POLICY)")
    xs = [torch.rand((b, 2), generator=gen, device=dev) for b in REQUESTS]
    torch.cuda.synchronize()
    reset_counts()
    answers = []
    for i, x in enumerate(xs):
        # since slice 22 the first request of a shape runs once (the
        # warm-up) and is captured: G and M twice a shape
        y = model.trainer.inference(x)
        torch.cuda.synchronize()
        check(grid_encode_fwd.launches == 2 * (i + 1) and fused_mlp_fwd.launches == 2 * (i + 1),
              f"request {i}: launch counts G={grid_encode_fwd.launches} "
              f"M={fused_mlp_fwd.launches}, expected {2 * (i + 1)} each")
        answers.append(y)
    inf_launches = first_order_counts()
    for x, y in zip(xs, answers):
        check(y.shape == (x.shape[0], 3) and y.dtype == torch.float32,
              f"answer {tuple(y.shape)} {y.dtype}")
        with torch.inference_mode():
            abs_err, rel_err = compare(y, plain_inference(model, x), "model")
        print(f"request B={x.shape[0]}: ({x.shape[0]}, 3) float32, max abs err "
              f"{abs_err:.3e} vs plain path (rtol 2e-2, atol 2e-3)")
    print(f"inference-path launches: G {inf_launches['G']}, M {inf_launches['M']}")

    phase("slice: one DEFAULT_POLICY (fp32) request")
    model32 = create_from_config(2, 3, CONFIG, policy=DEFAULT_POLICY)
    with torch.no_grad():
        model32.network.encoding.grid.copy_(enc.grid)
    x = xs[1]
    g0, m0 = grid_encode_fwd.launches, fused_mlp_fwd.launches
    y = model32.trainer.inference(x)
    torch.cuda.synchronize()
    check((grid_encode_fwd.launches - g0, fused_mlp_fwd.launches - m0) == (2, 2),
          "fp32 request did not launch G and M twice each (the warm-up and the capture)")
    with torch.inference_mode():
        abs_err, _ = compare(y, plain_inference(model32, x), "mlp-f32")
    print(f"fp32 request B={x.shape[0]}: max abs err {abs_err:.3e} (rtol 1e-5, atol 1e-5)")

    phase("grid backward (GB) vs plain, config_hash geometry")
    gb_err = 0.0
    for batch in (MAIN_BATCH, MAIN_BATCH - 37):
        x = torch.rand((batch, 2), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            table = enc.grid.detach().to(dtype)
            dcols = torch.randn((spec.n_output_dims, batch), generator=gen,
                                device=dev).to(dtype)
            for layout, dc in (("SoA", dcols), ("AoS", dcols.t().contiguous().t())):
                abs_err = grid_bwd_case(spec, table, x, dc, f"B={batch} dcols {layout}")
                if dtype == torch.bfloat16:
                    gb_err = max(gb_err, abs_err)

    phase("fused-MLP backward (MB) vs plain")
    mb_err = 0.0
    for batch in (MAIN_BATCH, MAIN_BATCH - 37):
        for dtype in (torch.bfloat16, torch.float32):
            err = mlp_bwd_case(gen, dev, mlp_dims(32, 64, 2), batch, dtype)
            if dtype == torch.bfloat16:
                mb_err = max(mb_err, err)
    for width in (16, 32, 128):
        for dtype in (torch.bfloat16, torch.float32):
            mlp_bwd_case(gen, dev, mlp_dims(32, width, 2), 4133, dtype, soa_in=False,
                         soa_out=True)

    phase("slice 2: one training step through model.trainer (BF16_POLICY), "
          "gradients vs the plain path")
    tmodel = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    with torch.no_grad():
        tmodel.network.encoding.grid.uniform_(-1, 1, generator=gen)
    x = torch.rand((MAIN_BATCH, 2), generator=gen, device=dev)
    target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
    check_step_gradients(tmodel, x, target)

    # The training path: counts set to 0 here, read after the fit loop.
    torch.cuda.synchronize()
    reset_counts()
    step_loss = tmodel.trainer.training_step(x, target)
    torch.cuda.synchronize()
    check(first_order_counts() == {"G": 1, "M": 1, "GB": 1, "MB": 1},
          f"training step launches {counts()}, expected one of each kernel")
    check(bool(torch.isfinite(step_loss)), "training step loss is not finite")
    print(f"training_step: loss {step_loss.item():.6f}; launches {counts()}")

    phase(f"slice 2: {FIT_STEPS} steps of make_training_loop at B={MAIN_BATCH} "
          "on synthetic_image(1024, 1024), CUDA graph replay")
    image = synthetic_image(1024, 1024)
    fit = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    sampler = ImageSampler(image, seed=0)
    fit_loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                              FIT_STEPS)
    t0 = time.time()
    fit_losses = fit_loop()
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    # Graph replays run the kernels without calling their wrappers: the
    # counts hold the training step, the loop's eager warm-up step and its
    # captured step, one launch of each kernel apiece.
    train_launches = first_order_counts()
    check(train_launches == {"G": 3, "M": 3, "GB": 3, "MB": 3},
          f"training path launches {train_launches}, expected 3 of each kernel")
    fit_losses = fit_losses.cpu()
    check(bool(torch.isfinite(fit_losses).all()), "non-finite training loss")
    first, last10 = float(fit_losses[0]), float(fit_losses[-10:].mean())
    coords = sampler.full_grid_coords()
    fit_psnr = psnr(fit.trainer.inference(coords), sampler.image.reshape(-1, 3))
    print(f"kernels: {FIT_STEPS} steps in {fit_s:.2f} s (capture included); loss "
          f"{first:.4f} -> {last10:.4f} (mean of the last 10, "
          f"{last10 / first:.4f}x); PSNR {fit_psnr:.2f} dB; "
          f"training-path launches {train_launches}")

    plain = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    plain_sampler = ImageSampler(image, seed=0)
    t0 = time.time()
    plain_losses = torch.stack([plain_training_step(plain, *plain_sampler.sample_batch(MAIN_BATCH))
                                for _ in range(FIT_STEPS)]).cpu()
    plain_s = time.time() - t0
    with torch.inference_mode():
        plain_psnr = psnr(plain_inference(plain, coords), plain_sampler.image.reshape(-1, 3))
    p_first, p_last10 = float(plain_losses[0]), float(plain_losses[-10:].mean())
    print(f"plain versions: {FIT_STEPS} steps in {plain_s:.2f} s; loss {p_first:.4f} -> "
          f"{p_last10:.4f} ({p_last10 / p_first:.4f}x); PSNR {plain_psnr:.2f} dB")
    check(last10 < 0.2 * first, f"loss floor missed: {last10} >= 0.2 x {first}")
    check(fit_psnr > 20.0, f"PSNR floor missed: {fit_psnr:.2f} dB")

    loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                          LOOP_STEPS)   # replays fit's captured step
    t = slice_times("config_hash", tmodel, x, target, loop)
    replaces = {
        "G": "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel); "
             "tcnn_tpu/ops/pallas/grid_matmul.py:734 (_gather_kernel_xor)",
        "M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
        "GB": "tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel); "
              "tcnn_tpu/ops/pallas/grid_matmul.py:602 (_scatter_kernel_xor)",
        "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)"}
    # launches: the training path's counts (slice 2's main path); G and M
    # also ran in the inference path, whose counts are kept beside them.
    return report_entries("", t, replaces, train_launches,
                          {"G": g_err, "M": m_err, "GB": gb_err, "MB": mb_err},
                          {"launches_inference": {k: inf_launches[k] for k in ("G", "M")}}), t


def config_btf_slice(gen, dev):
    """Slice 3 on config_btf: kernel checks at its shapes, its serving and
    training paths, the fit and the times; returns the report entries."""
    from tcnn_tpu_torch import BF16_POLICY, create_from_config
    from tcnn_tpu_torch.common import HashType
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd, grid_encode_fwd,
                                                     grid_encode_plain)
    from tcnn_tpu_torch.samples.fit_btf import batch_sampler, evaluate
    from tcnn_tpu_torch.tools.plain_path import plain_inference, plain_training_step

    btf = create_from_config(6, 3, BTF_CONFIG, policy=BF16_POLICY)
    benc, net = btf.network.encoding, btf.network.network
    grid = benc.nested[0]
    spec = grid.spec
    live = list(range(spec.n_levels))
    check(spec.n_params == BTF_GRID_PARAMS and spec.n_dims == 4
          and spec.hash_type == HashType.COHERENT_ADD,
          f"config_btf grid: {spec.n_params} parameters, {spec.n_dims}-D, {spec.hash_type}")
    check([tuple(w.shape) for w in net.layers] == mlp_dims(40, 64, 3),
          f"config_btf MLP {[tuple(w.shape) for w in net.layers]}")
    with torch.no_grad():
        grid.grid.uniform_(-1, 1, generator=gen)
    print(f"config_btf: {btf.trainer.n_params()} parameters, grid of "
          f"{spec.n_entries} rows (levels 0-1 dense, {spec.levels[0].size} and "
          f"{spec.levels[1].size} rows; levels 2-15 hashed, {spec.levels[2].size} rows)")
    # x of the BTF path: the grid reads columns 0-3 of a (B, 6) tensor.
    x6 = torch.rand((MAIN_BATCH, 6), generator=gen, device=dev)
    xg = x6[:, :4]
    check(not xg.is_contiguous(), "the grid's input is expected to be a strided view")

    phase("config_btf: grid encode (G) vs plain on a strided (B, 6) slice")
    g_err = 0.0
    sum_atol = ((1 << spec.n_dims) + 2 * spec.n_dims) * 2.0 ** -24   # see the docstring
    for dtype in (torch.float32, torch.bfloat16):
        table = grid.grid.detach().to(dtype)
        for soa in (False, True):
            with torch.inference_mode():
                got = grid_encode_fwd(spec, table, xg, live, soa=soa)
                torch.cuda.synchronize()
                want = grid_encode_plain(spec, table, xg, live, soa=soa)
            abs_err, rel_err = compare(got, want, "grid-bf16" if dtype == torch.bfloat16
                                       else "grid-f32", atol=sum_atol)
            g_err = max(g_err, abs_err)
            print(f"B={MAIN_BATCH} table={str(dtype)[6:]} {'SoA' if soa else 'AoS'}: "
                  f"max abs err {abs_err:.3e}, max rel err {rel_err:.3e} "
                  f"({f'one bf16 ulp + {sum_atol:.3e}' if dtype == torch.bfloat16 else 'rtol 1e-5, atol 1e-6'})")

    phase("config_btf: grid backward (GB) vs plain on the strided slice; the "
          "CoherentPrime grid of the same geometry (row 11's configuration)")
    gb_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        table = grid.grid.detach().to(dtype)
        # the model's layout: columns 0-31 of MB's (B, 40) input gradient
        dfull = torch.randn((MAIN_BATCH, 40), generator=gen, device=dev).to(dtype)
        dc = dfull[:, :spec.n_output_dims].t()
        err = grid_bwd_case(spec, table, xg, dc, f"B={MAIN_BATCH} dcols (B, 40)[:, :32].t()")
        gb_err = max(gb_err, err) if dtype == torch.bfloat16 else gb_err
    prime = grid_ops.make_grid_spec(4, 16, 2, 19, 16, 1.5, hash_type=HashType.COHERENT_PRIME)
    check(sum(lv.use_hash for lv in prime.levels) == 14 and prime.n_params == BTF_GRID_PARAMS,
          "CoherentPrime grid geometry")
    prime_table = torch.zeros(prime.n_params, dtype=torch.bfloat16, device=dev)
    prime_dc = torch.randn((prime.n_output_dims, MAIN_BATCH), generator=gen,
                           device=dev).to(torch.bfloat16)
    gb_prime_err = grid_bwd_case(prime, prime_table, xg, prime_dc,
                                 f"CoherentPrime 4-D, 2^19-row levels, B={MAIN_BATCH}")
    with torch.inference_mode():
        gb_prime_ms = graph_ms(lambda: grid_encode_bwd(prime, prime_table, xg, prime_dc, live))
    print(f"GB on the CoherentPrime grid: {gb_prime_ms:.4f} ms on the device")

    phase("config_btf: fused MLP (M) and its backward (MB) vs plain, 40 -> 64 x 3 -> 3")
    m_err = mb_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        err = mlp_case(gen, dev, mlp_dims(40, 64, 3), MAIN_BATCH, dtype, soa_in=False)
        m_err = max(m_err, err) if dtype == torch.bfloat16 else m_err
        err = mlp_bwd_case(gen, dev, mlp_dims(40, 64, 3), MAIN_BATCH, dtype, soa_in=False,
                           flips=True)
        mb_err = max(mb_err, err) if dtype == torch.bfloat16 else mb_err

    phase(f"slice 3: one config_btf request of {MAIN_BATCH} through "
          "model.trainer.inference (BF16_POLICY)")
    torch.cuda.synchronize()
    reset_counts()
    y = btf.trainer.inference(x6)
    torch.cuda.synchronize()
    inf_launches = first_order_counts()
    check(inf_launches == {"G": 2, "M": 2, "GB": 0, "MB": 0},
          f"config_btf request launches {inf_launches}, expected G and M twice (the warm-up "
          f"and the capture)")
    check(y.shape == (MAIN_BATCH, 3) and y.dtype == torch.float32, f"answer {tuple(y.shape)}")
    with torch.inference_mode():
        abs_err, _ = compare(y, plain_inference(btf, x6), "model")
    print(f"request: ({MAIN_BATCH}, 3) float32, max abs err {abs_err:.3e} vs plain path "
          f"(rtol 2e-2, atol 2e-3); launches {inf_launches}")

    phase("slice 3: one config_btf training step, gradients vs the plain path")
    target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
    check_step_gradients(btf, x6, target, flips=True)
    # The training path: counts set to 0 here, read after the fit loop.
    torch.cuda.synchronize()
    reset_counts()
    step_loss = btf.trainer.training_step(x6, target)
    torch.cuda.synchronize()
    check(first_order_counts() == {"G": 1, "M": 1, "GB": 1, "MB": 1},
          f"training step launches {counts()}, expected one of each kernel")
    check(bool(torch.isfinite(step_loss)), "training step loss is not finite")
    print(f"training_step: loss {step_loss.item():.6f}; launches {counts()}")

    phase(f"slice 3: {FIT_STEPS} steps of make_training_loop at B={MAIN_BATCH} "
          "on synthetic_btf, CUDA graph replay")
    fit = create_from_config(6, 3, BTF_CONFIG, policy=BF16_POLICY)
    fit_loop = fit.trainer.make_training_loop(batch_sampler(MAIN_BATCH, dev), FIT_STEPS)
    t0 = time.time()
    fit_losses = fit_loop()
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    train_launches = first_order_counts()   # the step, the loop's warm-up and its capture
    check(train_launches == {"G": 3, "M": 3, "GB": 3, "MB": 3},
          f"training path launches {train_launches}, expected 3 of each kernel")
    fit_losses = fit_losses.cpu()
    check(bool(torch.isfinite(fit_losses).all()), "non-finite training loss")
    first, last10 = float(fit_losses[0]), float(fit_losses[-10:].mean())
    mse, rel = evaluate(fit.trainer.inference, dev)
    _, rel_zero = evaluate(lambda x: x.new_zeros((x.shape[0], 3)), dev)
    print(f"kernels: {FIT_STEPS} steps in {fit_s:.2f} s (capture included); loss "
          f"{first:.4f} -> {last10:.4f} (mean of the last 10, {last10 / first:.4f}x); "
          f"held-out MSE {mse:.6f}, relL2 {rel:.6f} (zero prediction {rel_zero:.6f}); "
          f"training-path launches {train_launches}")
    plain = create_from_config(6, 3, BTF_CONFIG, policy=BF16_POLICY)
    plain_batches = batch_sampler(MAIN_BATCH, dev)
    t0 = time.time()
    plain_losses = torch.stack([plain_training_step(plain, *plain_batches(i))
                                for i in range(PLAIN_BTF_STEPS)]).cpu()
    plain_s = time.time() - t0
    with torch.inference_mode():
        p_mse, p_rel = evaluate(lambda x: plain_inference(plain, x), dev)
    p_first, p_last10 = float(plain_losses[0]), float(plain_losses[-10:].mean())
    print(f"plain versions: {PLAIN_BTF_STEPS} steps in {plain_s:.2f} s; loss {p_first:.4f} -> "
          f"{p_last10:.4f} ({p_last10 / p_first:.4f}x); held-out MSE {p_mse:.6f}, "
          f"relL2 {p_rel:.6f}")
    for who, f, l10, r in (("kernels", first, last10, rel), ("plain", p_first, p_last10, p_rel)):
        check(l10 < BTF_LOSS_RATIO * f, f"{who}: BTF loss floor missed: {l10} >= "
              f"{BTF_LOSS_RATIO} x {f}")
        check(r < BTF_REL_FLOOR, f"{who}: BTF relL2 floor missed: {r} >= {BTF_REL_FLOOR}")

    loop = fit.trainer.make_training_loop(batch_sampler(MAIN_BATCH, dev, seed=1),
                                          LOOP_STEPS)   # replays fit's captured step
    t = slice_times("config_btf", btf, x6, target, loop)
    replaces = {
        "G": "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel)",
        "M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
        "GB": "tcnn_tpu/ops/pallas/scatter.py:576 (_pair_kernel); "
              "tcnn_tpu/ops/pallas/scatter.py:392 (_weighted_kernel); "
              "tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel)",
        "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)"}
    return report_entries(" (config_btf)", t, replaces, train_launches,
                          {"G": g_err, "M": m_err, "GB": max(gb_err, gb_prime_err),
                           "MB": mb_err},
                          {"launches_inference": {k: inf_launches[k] for k in ("G", "M")}})


ONEBLOB_CONFIG = "configs/config_oneblob.json"
ONEBLOB_STEPS = 300
# The JAX package's run of the same fit, `python samples/mlp_learning_an_image.py
# none configs/config_oneblob.json 300` on the CPU (BF16_POLICY, 2^18 samples a
# step, synthetic_image(1024, 1024)): loss 0.134945 at step 100, 0.009874 at
# 200, 0.006309 at 300, final PSNR 29.68 dB.  Adam at lr 1e-2 makes this MLP's
# loss spike now and then, so the floor on the mean of the last 100 steps is
# 10x the JAX run's loss at step 200; the PSNR floor is config_hash's, 20 dB.
ONEBLOB_LOSS_FLOOR = 0.1
ONEBLOB_PSNR_FLOOR = 20.0


def config_oneblob_slice(gen, dev):
    """configs/config_oneblob.json (OneBlob of 64 bins -> FullyFusedMLP 128
    x 5 -> 3, ReLU; BF16_POLICY), the MLP kernel MB takes at half tiles: M
    and MB against their plain versions at its shape in both dtypes, one
    training step's gradients against the plain path's, the fit through
    make_training_loop with the JAX package's loss as its floor, and the
    times.  Returns the report entries of M and MB at this shape."""
    from tcnn_tpu_torch import BF16_POLICY, create_from_config
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_fwd, fused_mlp_plain)
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image
    from tcnn_tpu_torch.utils.metrics import psnr

    model = create_from_config(2, 3, ONEBLOB_CONFIG, policy=BF16_POLICY)
    net = model.network.network
    dims = mlp_dims(128, 128, 5)
    check([tuple(w.shape) for w in net.layers] == dims,
          f"config_oneblob MLP {[tuple(w.shape) for w in net.layers]}")

    phase(f"config_oneblob: M and MB vs plain at 128 -> 128 x 5 -> 3, B={MAIN_BATCH}")
    err = {"M": 0.0, "MB": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        e_m = mlp_case(gen, dev, dims, MAIN_BATCH, dtype, soa_in=False, rounding=True)
        e_mb = mlp_bwd_case(gen, dev, dims, MAIN_BATCH, dtype, soa_in=False, flips=True)
        if dtype == torch.bfloat16:
            err = {"M": e_m, "MB": e_mb}

    phase("config_oneblob: one training step through model.trainer (BF16_POLICY), "
          "gradients vs the plain path")
    x = torch.rand((MAIN_BATCH, 2), generator=gen, device=dev)
    target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
    check_step_gradients(model, x, target, flips=True)
    torch.cuda.synchronize()
    reset_counts()
    step_loss = model.trainer.training_step(x, target)
    torch.cuda.synchronize()
    check(first_order_counts() == {"G": 0, "M": 1, "GB": 0, "MB": 1},
          f"config_oneblob step launches {counts()}, expected M and MB once")
    check(bool(torch.isfinite(step_loss)), "config_oneblob step loss is not finite")

    phase(f"config_oneblob: {ONEBLOB_STEPS} steps of make_training_loop at B={MAIN_BATCH} "
          f"on synthetic_image(1024, 1024), CUDA graph replay")
    fit = create_from_config(2, 3, ONEBLOB_CONFIG, policy=BF16_POLICY)
    sampler = ImageSampler(synthetic_image(1024, 1024), seed=0)
    fit_loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                              ONEBLOB_STEPS)
    reset_counts()
    t0 = time.time()
    losses = fit_loop()
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = first_order_counts()   # the loop's eager warm-up step and its capture
    check(launches == {"G": 0, "M": 2, "GB": 0, "MB": 2},
          f"config_oneblob loop launches {launches}, expected M and MB twice")
    losses = losses.cpu()
    check(bool(torch.isfinite(losses).all()), "non-finite config_oneblob loss")
    first, last100 = float(losses[0]), float(losses[-100:].mean())
    coords = sampler.full_grid_coords()
    fit_psnr = psnr(fit.trainer.inference(coords), sampler.image.reshape(-1, 3))
    print(f"fit: {ONEBLOB_STEPS} steps in {fit_s:.2f} s (capture included); loss {first:.4f} "
          f"-> {last100:.6f} (mean of the last 100; floor {ONEBLOB_LOSS_FLOOR}, from the JAX "
          f"package's run); PSNR {fit_psnr:.2f} dB; launches {launches}")
    check(last100 < ONEBLOB_LOSS_FLOOR,
          f"config_oneblob loss floor missed: {last100} >= {ONEBLOB_LOSS_FLOOR}")
    check(fit_psnr > ONEBLOB_PSNR_FLOOR, f"config_oneblob PSNR floor missed: {fit_psnr:.2f} dB")

    phase(f"config_oneblob times at B={MAIN_BATCH}: M, MB, the step and the loop")
    bf16, relu, none = torch.bfloat16, net.activation, net.output_activation
    ws = [w.detach().to(bf16) for w in net.layers]
    t = {}
    with torch.no_grad():
        feats = model.network.encoding(x).to(bf16)
        m_args = (ws, feats, relu, none, bf16, torch.float32, False, False)
        pred = fused_mlp_fwd(*m_args)
    p = pred.detach().requires_grad_()
    (dy,) = torch.autograd.grad(model.loss(p, target), p)
    with torch.inference_mode():
        mb_args = (ws, feats, dy, relu, none, bf16, False, False)
        dfeats = fused_mlp_bwd(*mb_args)[1]
        hs = chain_activations(ws, feats)
        t["M"] = graph_ms(lambda: fused_mlp_fwd(*m_args))
        t["M plain"] = eager_ms(lambda: fused_mlp_plain(*m_args))
        t["M library"] = graph_ms(lambda: library_chain(ws, feats))
        t["MB"] = graph_ms(lambda: fused_mlp_bwd(*mb_args))
        t["MB plain"] = eager_ms(lambda: fused_mlp_bwd_plain(*mb_args))
        t["MB library"] = graph_ms(lambda: library_bwd(ws, hs, dy))
        t["OneBlob"] = graph_ms(lambda: model.network.encoding(x))
    trainer = model.trainer
    t["step"] = time_ms(lambda: trainer.training_step(x, target))
    t["step device"] = graph_ms(lambda: trainer.training_step(x, target))
    loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                          LOOP_STEPS)   # replays fit's captured step
    loop_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        loop_times.append((time.perf_counter() - t0) * 1e3 / LOOP_STEPS)
    t["loop step"] = float(np.median(loop_times))
    m_flops = 2 * MAIN_BATCH * sum(w.numel() for w in ws)
    record_bounds(t, {
        "M": (nbytes(feats, *ws) + MAIN_BATCH * 3 * 4, m_flops, PEAK_BF16),
        "MB": (nbytes(feats, dy, *ws, dfeats) + sum(w.numel() for w in ws) * 4, 3 * m_flops,
               PEAK_BF16)})
    rest = t["step device"] - t["M"] - t["MB"] - t["OneBlob"]
    print(f"training step at B={MAIN_BATCH}: {t['step']:.4f} ms eager with the host's work, "
          f"{t['step device']:.4f} ms of device work (idle share "
          f"{1 - t['step device'] / t['step']:.3f}); split: M {t['M']:.4f} ms, MB "
          f"{t['MB']:.4f} ms, OneBlob {t['OneBlob']:.4f} ms, loss, Adam and the rest "
          f"{rest:.4f} ms")
    print(f"make_training_loop at B={MAIN_BATCH}: {t['loop step']:.4f} ms per step "
          f"(median of 3 calls of {LOOP_STEPS} steps), "
          f"{MAIN_BATCH / t['loop step'] * 1e3:.4e} training samples/s, idle share "
          f"{1 - t['step device'] / t['loop step']:.3f}")
    replaces = {"M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
                "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)"}
    return report_entries(" (config_oneblob)", t, replaces, launches, err)


SDF_FIT_STEPS = 500          # the JAX sample's default run: 500 steps at 2^14
SDF_FIT_BATCH_POW = 14
SDF_LOSS_FLOOR = 0.05        # see the docstring: JAX 0.017435, a zero model 0.1
SDF_ERROR_FLOOR = 0.1        # JAX 0.0675, a zero prediction 0.0667


def compare_rel(got, want, rel, what):
    """Max abs error; raises beyond ``rel`` of want's largest magnitude (a
    zero ``want`` needs a zero ``got``)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    lim = rel * want.float().abs().max().item()
    check(err <= lim, f"{what}: max abs err {err:.3e} beyond {lim:.3e}")
    return err


def rel_err(got, want):
    """Max abs error over want's largest magnitude (no bound)."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def compare_rel_sum(got, want, atol, what):
    """Max abs error of fp32 sums; raises where |d| > 1e-5·|want| + atol
    (``atol`` the fp32 sum's own error where its terms cancel)."""
    check(got.shape == want.shape and got.dtype == want.dtype == torch.float32,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > 1e-5 * want.abs() + atol
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements beyond tolerance, "
          f"max abs err {err.max().item():.3e}")
    return err.max().item()


def sdf_flip_explained_bwd(net, xs, xv, frac=None):
    """MB's plain version for the plain eikonal step, its two calls (the
    surface term, then x_vol) held row by row against kernel MB's input
    gradients in the kernel step (G, M and MB on the same x and per-sample
    level fractions, as the step computes them), and each row that a
    switched fp32 ReLU explains (``compare_input_grad``) replaced by its
    flipped variant: a pre-activation may lie within fp32 rounding of 0,
    and the switch moves that sample's whole share of the table gradient."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd_plain

    kernel_dx = kernel_mlp_dx(net, xs, xv, frac)

    def bwd(weights, x, g, act, out_act, cdt, soa_in, soa_out):
        dws, dx = fused_mlp_bwd_plain(weights, x, g, act, out_act, cdt, soa_in, soa_out)
        got = kernel_dx.pop(0)
        _, rows, variants = compare_input_grad(got, dx, weights, x, g, out_act, soa_in,
                                               soa_out, "eikonal step MB dx", cdt)
        dx = dx.clone()
        dx.t()[rows] = variants.to(dx.dtype)
        return dws, dx

    return bwd


def kernel_mlp_dx(net, xs, xv, frac=None):
    """Kernel MB's input gradients in the eikonal step's two MLP backwards
    (the surface term, then x_vol), on the features G gives and the output
    gradients the step takes (G, M and MB on the same x and per-sample level
    fractions, as the step computes them)."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd, fused_mlp_fwd
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_fwd

    enc, mlp = net.encoding, net.network
    spec, ws = enc.spec, [w.detach() for w in mlp.layers]
    args = (mlp.activation, mlp.output_activation, torch.float32)
    live = list(range(spec.n_levels))
    out = []
    with torch.no_grad():
        for x, surface in ((xs, True), (xv, False)):
            feats = grid_encode_fwd(spec, enc.grid.detach(), x, live, soa=True, level_frac=frac)
            y = fused_mlp_fwd(ws, feats, *args, torch.float32, True, False)
            dy = y * (2.0 / x.shape[0]) if surface else torch.ones_like(y)
            out.append(fused_mlp_bwd(ws, feats, dy, *args, True, False)[1])
    return out


def kernel_dx_bwd(net, xs, xv):
    """MB's plain version for the plain eikonal step with kernel MB's dx
    (``kernel_mlp_dx``), so that the plain step's grid kernels get the
    kernel step's output gradient."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd_plain

    kernel_dx = kernel_mlp_dx(net, xs, xv)

    def bwd(weights, x, g, act, out_act, cdt, soa_in, soa_out):
        dws, _ = fused_mlp_bwd_plain(weights, x, g, act, out_act, cdt, soa_in, soa_out)
        return dws, kernel_dx.pop(0)

    return bwd


def sdf_slice(gen, dev):
    """Slice 4, second order: kernels GI and GG against their plain
    versions at the SDF sample's geometry, kernel RS in a phase of its own
    (no path of the port calls it since GG adds its table gradient
    itself), one eikonal step's gradients against the plain eikonal step,
    the sample's fit (the main path), and the times of the step and its
    kernels.  Returns the report entries."""
    from tcnn_tpu_torch import Policy, create_from_config
    from tcnn_tpu_torch.common import HashType, InterpolationType
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_bwd_plain,
                                                   fused_mlp_bwd_plain, fused_mlp_fwd,
                                                   fused_mlp_plain)
    from tcnn_tpu_torch.ops.cuda.grid_encode import (
        grid_encode_bwd, grid_encode_bwd_bwd, grid_encode_bwd_bwd_plain,
        grid_encode_bwd_input, grid_encode_bwd_input_plain, grid_encode_bwd_plain,
        grid_encode_fwd, grid_encode_plain)
    from tcnn_tpu_torch.ops.cuda.scatter import (row_scatter_add, row_scatter_add_plain,
                                                 scatter_add_cols, scatter_add_rows,
                                                 scatter_add_rows_flat)
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
    from tcnn_tpu_torch.tools.plain_path import gg_rows_and_g, plain_sdf_loss_and_grads

    model = create_from_config(3, 1, sdf.CONFIG, policy=Policy())
    net, opt = model.network, model.optimizer
    enc, mlp = net.encoding, net.network
    spec = enc.spec
    live = list(range(spec.n_levels))
    check(spec.n_dims == 3 and spec.n_levels == 8 and spec.n_features_per_level == 2
          and spec.interpolation == InterpolationType.SMOOTHSTEP
          and spec.hash_type == HashType.COHERENT_PRIME,
          f"SDF grid: {spec.n_dims}-D, {spec.n_levels} levels, {spec.interpolation}")
    check([tuple(w.shape) for w in mlp.layers] == mlp_dims(16, 64, 2, d_out=1),
          f"SDF MLP {[tuple(w.shape) for w in mlp.layers]}")
    print(f"SDF model: {net.n_params()} parameters, grid of {spec.n_entries} rows "
          f"({sum(not lv.use_hash for lv in spec.levels)} dense levels), fp32 policy")
    with torch.no_grad():   # O(1) features, as in the other slices' checks
        enc.grid.uniform_(-1, 1, generator=gen)
    B = MAIN_BATCH
    F, D = spec.n_features_per_level, spec.n_dims

    phase(f"SDF geometry: GI and GG vs plain at B={B}, f32 and bf16 tables")
    x = torch.rand((B, D), generator=gen, device=dev) * 0.9 + 0.05
    ddx = torch.randn((B, D), generator=gen, device=dev)
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        table = enc.grid.detach().to(dtype)
        dcols = torch.randn((spec.n_output_dims, B), generator=gen, device=dev).to(dtype)
        with torch.inference_mode():
            got = grid_encode_bwd_input(spec, table, x, dcols, live)
            torch.cuda.synchronize()
            e_gi = compare_rel(got, grid_encode_bwd_input_plain(spec, table, x, dcols, live),
                               1e-5, "GI dx")
            e_gg, e_flat = check_second_order(spec, table, x, dcols, ddx, live, label="SDF")
        if dtype == torch.float32:
            err = {"GI": e_gi, "GG": max(e_gg, e_flat)}
        print(f"table={str(dtype)[6:]}: GI max abs err {e_gi:.3e}, GG d_dcols and d_x "
              f"{e_gg:.3e} (1e-5 of each output's max; bit for bit in a second launch), "
              f"table gradient {e_flat:.3e} (2^-11·S, S over its updates' terms"
              f"{' + one bf16 ulp' if dtype == torch.bfloat16 else ''})")

    phase("RS in a phase of its own (no path of the port calls it): its entry points, "
          "then F in {1, 2, 4, 8} on random rows and row 10's column streams, vs plain")
    # the entry points a caller of the JAX package's scatters would call, on
    # the (rows, g) layout GG's updates have at this batch (level-major)
    rows_sdf, g_sdf = gg_rows_and_g(spec, x, dcols.float(), ddx, live)
    torch.cuda.synchronize()
    reset_counts()
    with torch.inference_mode():
        rs_out = (scatter_add_rows(rows_sdf, g_sdf, spec.n_entries).reshape(-1),
                  scatter_add_rows_flat(rows_sdf, g_sdf, spec.n_entries, F),
                  scatter_add_cols(rows_sdf, g_sdf.t(), spec.n_entries))
    torch.cuda.synchronize()
    rs_launches = counts()["RS"]
    check(rs_launches == 3, f"RS's entry points launched RS {rs_launches} times, expected 3")
    with torch.inference_mode():
        want = row_scatter_add_plain(rows_sdf, g_sdf, spec.n_entries)
        scale = row_scatter_add_plain(rows_sdf, g_sdf.abs(), spec.n_entries)
        err["RS"] = max(compare_table_grad(o, want, scale, f"RS ({how})") for o, how in
                        zip(rs_out, ("scatter_add_rows", "scatter_add_rows_flat",
                                     "scatter_add_cols")))
    print(f"scatter_add_rows, scatter_add_rows_flat and scatter_add_cols on GG's "
          f"{rows_sdf.numel()} updates at the SDF layout (fp32): {rs_launches} launches, max "
          f"abs err {err['RS']:.3e} (2^-11·S, S = Σ|g|)")
    for f in (1, 2, 4, 8):
        m, n_rows = 1 << 22, 1 << 16
        idx = torch.randint(0, n_rows, (m,), generator=gen, device=dev, dtype=torch.int32)
        g = torch.randn((m, f), generator=gen, device=dev)
        with torch.inference_mode():
            scale = row_scatter_add_plain(idx, g.abs(), n_rows)
            want = row_scatter_add_plain(idx, g, n_rows)
            e_rows = compare_table_grad(row_scatter_add(idx, g, n_rows), want, scale,
                                        f"RS F={f}")
            streams = g.t().contiguous()   # F separate (M,) streams, read with strides (1, M)
            e_cols = compare_table_grad(scatter_add_cols(idx, streams, n_rows), want, scale,
                                        f"RS cols F={f}")
        print(f"F={f}, {m} updates into {n_rows} rows: max abs err {e_rows:.3e}, as column "
              f"streams {e_cols:.3e} (2^-11·S)")

    phase(f"slice 4: one eikonal step at B={B}, gradients vs the plain eikonal step")
    xs, xv = sdf.sample_points(gen, B, dev)
    reset_counts()
    loss, grads = sdf.loss_and_grads(net, xs, xv)
    torch.cuda.synchronize()
    step_launches = counts()
    want_loss, want, scale = plain_sdf_loss_and_grads(
        net, xs, xv, table_scale=True, mlp_bwd=sdf_flip_explained_bwd(net, xs, xv))
    check(abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item()),
          f"eikonal loss {loss.item()} vs plain {want_loss.item()}")
    check(set(grads) == set(want), f"gradient names {sorted(grads)}")
    for name in grads:
        if name == "encoding.grid":   # GB's and GG's atomics: per entry 2^-11·S
            ratio = (grads[name] - want[name]).abs() / (2.0 ** -11 * scale + 1e-30)
            for i in ratio.topk(3).indices.tolist():   # the entries nearest their bound
                level = max(l for l, lv in enumerate(spec.levels) if lv.offset * F <= i)
                print(f"table entry {i} (level {level}): {grads[name][i].item():.6e} vs "
                      f"{want[name][i].item():.6e}, S {scale[i].item():.3e}, "
                      f"{ratio[i].item():.3e} of its bound")
            e, how = compare_table_grad(grads[name], want[name], scale), "2^-11·S per entry"
        else:
            e, how = compare_rel(grads[name], want[name], 1e-4, name), "1e-4 of its max"
        print(f"gradient {name}: max abs err {e:.3e} vs the plain step (max |g| "
              f"{want[name].abs().max().item():.3e}; {how})")
    print(f"loss {loss.item():.6f}, plain {want_loss.item():.6f}; launches {step_launches}")
    # GB once: the first-order call's table gradient, which the step would
    # discard, is not computed (ops/grid_ops.py: _engine_will_use); no RS:
    # GG adds the table gradient of the input gradient itself
    per_step = {"G": 2, "M": 2, "MB": 2, "GB": 1, "GI": 1, "GG": 1, "RS": 0, "GT": 0,
                "MW": 0, "MBW": 0}
    check(step_launches == per_step, f"eikonal step launches {step_launches}, "
          f"expected {per_step}")

    reset_counts()
    dx = net.input_gradient(xv, 0)
    torch.cuda.synchronize()
    ig_launches = counts()
    check(ig_launches == {"G": 1, "M": 1, "GB": 0, "MB": 1, "GI": 1, "GG": 0, "RS": 0,
                          "GT": 0, "MW": 0, "MBW": 0},
          f"input_gradient launches {ig_launches}: expected no GB (its table gradient "
          f"would be thrown away)")
    check(dx.shape == (B, D) and bool(torch.isfinite(dx).all()), "input_gradient output")
    print(f"input_gradient at B={B}: launches {ig_launches}")

    phase(f"slice 4: the SDF sample's fit through create_from_config, model.network and "
          f"model.optimizer, {SDF_FIT_STEPS} steps at 2^{SDF_FIT_BATCH_POW}")
    torch.cuda.synchronize()
    reset_counts()
    fit = sdf.main(["fit_sdf_eikonal", str(SDF_FIT_STEPS), str(SDF_FIT_BATCH_POW)])
    torch.cuda.synchronize()
    fit_launches = counts()
    # the step's kernels in the eager warm-up step and in the capture (the
    # other steps replay the graph: no wrapper runs), then G and M for the
    # evaluation's request
    expect = {k: 2 * v for k, v in per_step.items()}
    expect["G"] += 1
    expect["M"] += 1
    check(fit_launches == expect, f"SDF fit launches {fit_launches}, expected {expect}")
    losses = fit["losses"]
    check(bool(torch.isfinite(losses).all()), "non-finite SDF loss")
    last10 = float(losses[-10:].mean())
    print(f"fit: loss {float(losses[0]):.6f} -> {last10:.6f} (mean of the last 10), mean "
          f"|sdf error| {fit['sdf_error']:.4f}, {fit['seconds']:.2f} s (a captured step "
          f"replayed); launches {fit_launches} (the step's {per_step} in the warm-up and in the "
          f"capture, and G and M once for the evaluation)")
    check(last10 < SDF_LOSS_FLOOR, f"SDF loss floor missed: {last10} >= {SDF_LOSS_FLOOR}")
    check(fit["sdf_error"] < SDF_ERROR_FLOOR,
          f"SDF error floor missed: {fit['sdf_error']} >= {SDF_ERROR_FLOOR}")

    phase(f"slice 4 times at B={B}: the eikonal step and its kernels, device time in a "
          f"CUDA graph of {N_TIMED} calls; plain versions eager")
    opt_state = opt.init(dict(net.named_parameters()), net.param_layout())
    t = {}

    def step_call():
        return sdf.step(net, opt, opt_state, xs, xv)

    t["step"] = time_ms(step_call)
    t["step device"] = graph_ms(step_call)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    step_call()
    torch.cuda.synchronize()
    t["step peak MB"] = (torch.cuda.max_memory_allocated() - base_bytes) / 1e6
    relu, none, f32 = mlp.activation, mlp.output_activation, torch.float32
    table = enc.grid.detach()
    ws = [w.detach() for w in mlp.layers]
    with torch.no_grad():   # tensors the MLP's second order can differentiate
        fs = grid_encode_fwd(spec, table, xs, live, soa=True)
        fv = grid_encode_fwd(spec, table, xv, live, soa=True)
        ys = fused_mlp_fwd(ws, fs, relu, none, f32, f32, True, False)
        dys = ys * (2.0 / B)
        ones = torch.ones_like(ys)
        dfs = fused_mlp_bwd(ws, fs, dys, relu, none, f32, True, False)[1]
        dfv = fused_mlp_bwd(ws, fv, ones, relu, none, f32, True, False)[1]
        gx = grid_encode_bwd_input(spec, table, xv, dfv, live)
    gxr = gx.clone().requires_grad_()
    (dgx,) = torch.autograd.grad(sdf.EIKONAL_WEIGHT * sdf.eikonal_loss(gxr), gxr)
    with torch.no_grad():   # tensors the MLP's second order can differentiate
        bb = grid_encode_bwd_bwd(spec, table, xv, dfv, dgx, live)
        # the step's GG updates as (rows, g), the layout RS is timed on
        rows, g = gg_rows_and_g(spec, xv, dfv, dgx, live)
    calls = {
        "G": (lambda: grid_encode_fwd(spec, table, xs, live, soa=True),
              lambda: grid_encode_plain(spec, table, xs, live, soa=True)),
        "M": (lambda: fused_mlp_fwd(ws, fs, relu, none, f32, f32, True, False),
              lambda: fused_mlp_plain(ws, fs, relu, none, f32, f32, True, False)),
        "MB": (lambda: fused_mlp_bwd(ws, fs, dys, relu, none, f32, True, False),
               lambda: fused_mlp_bwd_plain(ws, fs, dys, relu, none, f32, True, False)),
        "GB": (lambda: grid_encode_bwd(spec, table, xs, dfs, live),
               lambda: grid_encode_bwd_plain(spec, table, xs, dfs, live)),
        "GI": (lambda: grid_encode_bwd_input(spec, table, xv, dfv, live),
               lambda: grid_encode_bwd_input_plain(spec, table, xv, dfv, live)),
        "GG": (lambda: grid_encode_bwd_bwd(spec, table, xv, dfv, dgx, live),
               lambda: grid_encode_bwd_bwd_plain(spec, table, xv, dfv, dgx, live)),
        "RS": (lambda: row_scatter_add(rows, g, spec.n_entries),
               lambda: row_scatter_add_plain(rows, g, spec.n_entries)),
    }
    rs_acc = torch.zeros((spec.n_entries, F), device=dev)
    hs = chain_activations(ws, fs.t())
    library = {"M": lambda: library_chain(ws, fs.t()),
               "MB": lambda: library_bwd(ws, hs, dys),
               # one PyTorch call computing RS's function: index_add_ into zeros
               "RS": lambda: rs_acc.zero_().index_add_(0, rows, g)}
    with torch.no_grad():   # tensors the MLP's second order can differentiate
        # the first-order kernels at the SDF shapes (fp32, one output)
        err["G"] = compare(calls["G"][0](), calls["G"][1](), "grid-f32")[0]
        err["M"] = compare(calls["M"][0](), calls["M"][1](), "mlp-f32")[0]
        (got_dws, got_dx), (want_dws, want_dx) = calls["MB"][0](), calls["MB"][1]()
        err["MB"] = compare_mlp_grads([*got_dws, got_dx], [*want_dws, want_dx], f32, "MB")
        err["GB"] = compare_table_grad(calls["GB"][0](), calls["GB"][1](),
                                       grid_encode_bwd_plain(spec, table, xs, dfs.abs(), live))
        # GG on the step's own tensors, and RS on its updates as (rows, g)
        e_gg, e_flat = check_second_order(spec, table, xv, dfv, dgx, live, label="SDF step")
        err["GG"] = max(err["GG"], e_gg, e_flat)
        e_rs = compare_table_grad(calls["RS"][0](), calls["RS"][1](),
                                  row_scatter_add_plain(rows, g.abs(), spec.n_entries),
                                  "RS (step)")
        err["RS"] = max(err["RS"], e_rs)
        print("at the step's tensors: " + ", ".join(f"{k} max abs err {err[k]:.3e}"
                                                    for k in ("G", "M", "MB", "GB"))
              + f" (fp32 bounds of the config_hash checks); GG {e_gg:.3e}, its table "
              f"gradient {e_flat:.3e}; RS on GG's {rows.numel()} updates as (rows, g) "
              f"{e_rs:.3e} (2^-11·S)")
        for k, (kernel, plain) in calls.items():
            t[k] = graph_ms(kernel)
            t[k + " plain"] = eager_ms(plain)
            if k in library:
                t[k + " library"] = graph_ms(library[k])
        t["MLP second order"] = graph_ms(lambda: fused_mlp_bwd_bwd_plain(
            ws, fv, ones, bb.d_dcols, [None] * len(ws), relu, none, f32, f32, True, False))
        # GG at the fit's batch, 2^14 (the main path's shape), and its bound
        n14 = 1 << SDF_FIT_BATCH_POW
        x14, f14, d14 = xv[:n14], dfv[:, :n14], dgx[:n14]
        t["GG sdf 2^14"] = graph_ms(lambda: grid_encode_bwd_bwd(spec, table, x14, f14, d14, live))
        t["GG sdf 2^14 plain"] = eager_ms(
            lambda: grid_encode_bwd_bwd_plain(spec, table, x14, f14, d14, live))
        out14 = grid_encode_bwd_bwd(spec, table, x14, f14, d14, live)
    err["GG sdf 2^14"] = max(check_second_order(spec, table, x14, f14, d14, live,
                                                label="SDF step 2^14"))
    grads = sdf.loss_and_grads(net, xs, xv)[1]
    t["Adam"] = graph_ms(lambda: opt.step(opt_state, grads, dict(net.named_parameters())))

    consts = spec.n_levels * grid_ops.LEVEL_FIELDS * 4
    tb = touched_bytes(spec, xs, 4)
    tbv = touched_bytes(spec, xv, 4)
    L, C = spec.n_levels, 1 << D
    m_flops = 2 * B * sum(w.numel() for w in ws)
    corner = 4 * D + C * (D - 1)      # per (sample, level): positions and weights
    # M and MB in fp32 run plain fp32 FMA (csrc/fused_mlp.cu, fused_mlp_bwd.cu):
    # their products are bounded at the FMA units' peak.
    b = {
        "G": (nbytes(xs, fs) + tb + consts, grid_flops(spec, B), PEAK_FP32),
        "M": (nbytes(fs, *ws, ys), m_flops, PEAK_FP32),
        "MB": (nbytes(fs, dys, *ws, dfs) + sum(w.numel() for w in ws) * 4, 3 * m_flops,
               PEAK_FP32),
        "GB": (nbytes(xs, dfs, table) + consts, grid_flops(spec, B), PEAK_FP32),
        # GI: per corner the row's dot with dcols (2F), d w / dx (D·D), dx += (2D)
        "GI": (nbytes(xv, dfv, gx) + tbv + consts,
               B * L * (corner + C * (2 * F + D * D + 2 * D)), PEAK_FP32),
        # GG: x, ddx, dcols and the touched rows in; d_dcols, d_x and the
        # table gradient out (gg_flops: its operations)
        "GG": (nbytes(xv, dgx, dfv, *bb) + tbv + consts, gg_flops(spec, B), PEAK_FP32),
        "GG sdf 2^14": (nbytes(x14, d14, f14, *out14) + touched_bytes(spec, x14, 4) + consts,
                    gg_flops(spec, n14), PEAK_FP32),
        "RS": (nbytes(rows, g) + spec.n_params * 4, g.numel(), PEAK_FP32),
    }
    record_bounds(t, b)
    parts = {k + (" x2" if per_step[k] == 2 else ""): per_step[k] * t[k] for k in calls
             if per_step[k]}
    parts["MLP second order (torch ops)"] = t["MLP second order"]
    parts["Adam"] = t["Adam"]
    parts["loss, casts, gaps and the rest"] = t["step device"] - sum(parts.values())
    print(f"eikonal step at B={B}: {t['step']:.4f} ms eager with the host's work, "
          f"{t['step device']:.4f} ms of device work (idle share "
          f"{1 - t['step device'] / t['step']:.3f}); split: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    print(f"eikonal step's peak device memory above what it found allocated: "
          f"{t['step peak MB']:.1f} MB")

    replaces = {
        "G": "tcnn_tpu/ops/pallas/grid_matmul.py:734 (_gather_kernel_xor); "
             "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel)",
        "M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
        "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)",
        "GB": "tcnn_tpu/ops/pallas/grid_matmul.py:602 (_scatter_kernel_xor); "
              "tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel)",
        "GI": "none (jnp): tcnn_tpu/ops/grid_ops.py:1104 (_finish_interp_bwd) and "
              "autodiff of tcnn_tpu/ops/grid_ops.py:476 (_build_indices_weights)",
        "GG": "none (jnp): autodiff of tcnn_tpu/ops/grid_ops.py:1094 "
              "(_finish_interp_bwd) and of tcnn_tpu/ops/grid_ops.py:476",
        "RS": "tcnn_tpu/ops/pallas/scatter.py:106 (_scatter_kernel); "
              "tcnn_tpu/ops/pallas/scatter.py:187 (_scatter_cols_kernel)"}
    # launches: the fit's counts (the main path; RS 0, no path of the port
    # calls it); per step, the eikonal step's counts measured above; RS's
    # entry points' launches in its own phase apart
    entries_ = report_entries(" (sdf)", t, replaces, fit_launches, err,
                              {"launches_per_step": step_launches,
                               "phase_launches": {"RS": rs_launches},
                               "path": {"RS": "none: its own phase launches scatter_add_rows, "
                                              "scatter_add_rows_flat and scatter_add_cols on "
                                              "GG's updates at the SDF layout"}})
    entries_ += entries(t, [("GG sdf 2^14", "GG", replaces["GG"])], fit_launches, err,
                        {"batch": n14})
    return entries_


# The NeRF sample (slice 8): samples/fit_nerf_field.py at its defaults.  The
# JAX sample's run at those settings (`python samples/fit_nerf_field.py` on
# the CPU, fp32 policy: 400 steps of 2^12 rays x 48 samples, 128^2 render)
# read eval PSNR 36.89 dB (mse 0.000205); the floor is 3 dB below it.
NERF_PSNR_JAX = 36.89
NERF_PSNR_FLOOR = NERF_PSNR_JAX - 3.0
NERF_RAYS, NERF_SAMPLES = 1 << 12, 48
NERF_BATCH = NERF_RAYS * NERF_SAMPLES   # 196,608 field points a step
NERF_STEPS = 400
IMAGE_STEPS = 100
IMAGE_PSNR_FLOOR = 20.0


def live_pairs(spec, frac):
    """The (sample, level) pairs that the per-sample fractions ``frac`` keep."""
    from tcnn_tpu_torch.ops import grid_ops

    return int(grid_ops.level_mask(spec, list(range(spec.n_levels)), frac).sum())


def touched_rows_live(spec, x, frac):
    """The table rows that the live (sample, level) pairs touch: the rows G
    must read."""
    from tcnn_tpu_torch.ops import grid_ops

    L, C = spec.n_levels, 1 << spec.n_dims
    idx, _ = grid_ops.build_indices_weights(spec, x, list(range(L)))
    keep = grid_ops.level_mask(spec, list(range(L)), frac).bool()          # (L, B)
    rows = idx.reshape(L, C, -1)[keep[:, None, :].expand(-1, C, -1)]
    touched = torch.zeros(spec.n_entries, dtype=torch.bool, device=x.device)
    touched[rows] = True
    return int(touched.sum())


def nerf_slice(gen, dev):
    """Slice 8, the instant-ngp NeRF field (samples/fit_nerf_field.py,
    BF16_POLICY): masked G and GB, and M and MB at the two nets' shapes,
    against their plain versions at the sample's 196,608 points; one
    training step's gradients (both nets) against the plain path's; the
    launches of a step; the sample's fit at its defaults (the main path)
    with its PSNR floor; and the times.  Returns the report entries."""
    from tcnn_tpu_torch import BF16_POLICY, create_optimizer
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_fwd, fused_mlp_plain)
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd, grid_encode_bwd_plain,
                                                     grid_encode_fwd, grid_encode_plain)
    from tcnn_tpu_torch.samples import fit_nerf_field as nf
    from tcnn_tpu_torch.tools.plain_path import plain_nerf_loss_and_grads

    d_net, c_net = nf.build_model(BF16_POLICY, torch.Generator().manual_seed(0), dev)
    spec = d_net.encoding.spec
    d_dims, c_dims = mlp_dims(24, 64, 1, d_out=16), mlp_dims(31, 64, 2)
    check([tuple(w.shape) for w in d_net.network.layers] == d_dims
          and [tuple(w.shape) for w in c_net.network.layers] == c_dims
          and spec.n_dims == 3 and spec.n_levels == 12,
          f"NeRF nets {[tuple(w.shape) for w in d_net.network.layers]}, "
          f"{[tuple(w.shape) for w in c_net.network.layers]}")
    B, L, F = NERF_BATCH, spec.n_levels, spec.n_features_per_level
    live = list(range(L))
    print(f"NeRF density net: {d_net.n_params()} parameters, grid of {spec.n_entries} rows "
          f"({sum(not lv.use_hash for lv in spec.levels)} dense levels); colour net "
          f"{c_net.n_params()}; B = {NERF_RAYS} rays x {NERF_SAMPLES} samples = {B}")

    phase(f"NeRF: masked G and GB vs plain at B={B}, per-sample fractions over [0, 1]")
    x = torch.rand((B, 3), generator=gen, device=dev)
    frac = torch.rand(B, generator=gen, device=dev)
    on = torch.rand(B, generator=gen, device=dev) < 1 / 3   # a third on the level boundaries
    frac[on] = torch.randint(0, L + 1, (int(on.sum()),), generator=gen, device=dev).float() / L
    keep = grid_ops.level_mask(spec, live, frac).bool()
    sum_atol = ((1 << spec.n_dims) + 2 * spec.n_dims) * 2.0 ** -24   # as at config_btf
    err = {}
    for dtype in (torch.bfloat16, torch.float32):
        table = (torch.rand(spec.n_params, generator=gen, device=dev) * 2 - 1).to(dtype)
        dcols = torch.randn((L * F, B), generator=gen, device=dev).to(dtype)
        with torch.inference_mode():
            e_g = 0.0
            for soa in (True, False):
                got = grid_encode_fwd(spec, table, x, live, soa=soa, level_frac=frac)
                torch.cuda.synchronize()
                want = grid_encode_plain(spec, table, x, live, soa=soa, level_frac=frac)
                e_g = max(e_g, compare(got, want, "grid-bf16" if dtype == torch.bfloat16
                                       else "grid-f32", atol=sum_atol)[0])
                cols = (got if soa else got.t()).reshape(L, F, B)
                check(not bool(cols[~keep[:, None, :].expand(-1, F, -1)].any()),
                      "G wrote a nonzero value for a masked (sample, level)")
            got = grid_encode_bwd(spec, table, x, dcols, live, level_frac=frac)
            torch.cuda.synchronize()
            want = grid_encode_bwd_plain(spec, table, x, dcols, live, level_frac=frac)
            scale = grid_encode_bwd_plain(spec, table.float(), x, dcols.float().abs(), live,
                                          level_frac=frac)
            e_gb = compare_table_grad(got, want, scale, "GB masked")
            check(not bool(got[scale == 0].any()), "GB updated a row only masked pairs touch")
        if dtype == torch.bfloat16:
            err.update({"G": e_g, "GB": e_gb})
        bound = f"one bf16 ulp + {sum_atol:.3e}" if dtype == torch.bfloat16 else "rtol 1e-5"
        print(f"table={str(dtype)[6:]}: G max abs err {e_g:.3e} ({bound}; SoA and AoS; masked "
              f"pairs exact zeros), GB {e_gb:.3e} (2^-11·S); {int(keep.sum())} of {L * B} "
              f"(sample, level) pairs live")

    phase(f"NeRF: M and MB vs plain at 24 -> 64 -> 16 (SoA in) and 31 -> 64 x 2 -> 3 "
          f"(Sigmoid, AoS in), B={B}")
    sig = Activation.SIGMOID
    err_d, err_c = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        e = (mlp_case(gen, dev, d_dims, B, dtype, soa_in=True),
             mlp_bwd_case(gen, dev, d_dims, B, dtype, soa_in=True, flips=True),
             mlp_case(gen, dev, c_dims, B, dtype, soa_in=False, out_act=sig),
             mlp_bwd_case(gen, dev, c_dims, B, dtype, soa_in=False, flips=True, out_act=sig))
        if dtype == torch.bfloat16:
            err_d, err_c = {"M": e[0], "MB": e[1]}, {"M": e[2], "MB": e[3]}

    phase("NeRF: one training step (BF16_POLICY, frac 0.5: six of twelve levels live), "
          "gradients of both nets vs the plain path; launches per step")
    rays_o, rays_d = nf.sample_rays(gen, NERF_RAYS, dev)
    jitter = torch.rand((NERF_RAYS, NERF_SAMPLES), generator=gen, device=dev)
    loss, grads = nf.loss_and_grads(d_net, c_net, rays_o, rays_d, NERF_SAMPLES, jitter, 0.5)
    want_loss, want = plain_nerf_loss_and_grads(d_net, c_net, rays_o, rays_d, NERF_SAMPLES,
                                                jitter, 0.5)
    torch.cuda.synchronize()
    check(abs(loss.item() - want_loss.item()) <= 2e-2 * abs(want_loss.item()),
          f"NeRF step loss {loss.item()} vs plain {want_loss.item()}")
    check(set(grads) == set(want), f"NeRF gradient names {sorted(grads)}")
    for name in grads:
        e = compare_mlp_grads([grads[name]], [want[name]], torch.bfloat16, name)
        print(f"gradient {name}: max abs err {e:.3e} vs plain path (max |g| "
              f"{want[name].abs().max().item():.3e}, 2e-2 of it)")
    print(f"loss {loss.item():.6f}, plain path {want_loss.item():.6f}")
    opt = create_optimizer(nf.OPTIMIZER)
    opt_state = opt.init(*nf.params_and_layout(d_net, c_net))
    torch.cuda.synchronize()
    reset_counts()
    step_loss = nf.step(d_net, c_net, opt, opt_state, rays_o, rays_d, NERF_SAMPLES, jitter, 0.5)
    torch.cuda.synchronize()
    per_step = first_order_counts()
    check(per_step == {"G": 1, "M": 2, "GB": 1, "MB": 2},
          f"NeRF step launches {per_step}, expected G 1, M 2, GB 1, MB 2")
    check(bool(torch.isfinite(step_loss)), "NeRF step loss is not finite")
    print(f"launches per step: {per_step}")

    phase(f"NeRF: the sample's fit, fit_nerf_field.main at its defaults ({NERF_STEPS} steps "
          f"of {NERF_RAYS} rays x {NERF_SAMPLES} samples, 128^2 render), the main path")
    reset_counts()
    fit = nf.main(["fit_nerf_field"])
    torch.cuda.synchronize()
    fit_launches = first_order_counts()
    # the step (G, GB once, M, MB twice) in the eager warm-up and in the
    # capture, the other steps replaying the graph; the evaluation render
    # (one chunk of 2^14 rays) G once and M twice
    want_launches = {"G": 2 + 1, "M": 4 + 2, "GB": 2, "MB": 4}
    check(fit_launches == want_launches, f"NeRF fit launches {fit_launches}, expected "
          f"{want_launches}")
    losses = fit["losses"]
    check(bool(torch.isfinite(losses).all()), "non-finite NeRF loss")
    print(f"fit: {NERF_STEPS} steps in {fit['seconds']:.2f} s ({fit['seconds'] / NERF_STEPS * 1e3:.3f} "
          f"ms a step, a captured step replayed); loss {float(losses[:10].mean()):.6f} (first 10) -> "
          f"{float(losses[-10:].mean()):.6f} (last 10); eval PSNR {fit['psnr']:.2f} dB "
          f"(floor {NERF_PSNR_FLOOR:.2f}: the JAX sample's {NERF_PSNR_JAX} dB on the CPU, "
          f"fp32, less 3 dB); launches {fit_launches}")
    check(fit["psnr"] > NERF_PSNR_FLOOR,
          f"NeRF PSNR floor missed: {fit['psnr']:.2f} dB <= {NERF_PSNR_FLOOR:.2f}")

    phase(f"NeRF times at B={B}: G and GB at the fractions the fit issues (1.0, and 0.5 "
          f"while it warms up), M and MB of both nets (device time in a CUDA graph of "
          f"{N_TIMED} calls), the step eager")
    bf16, relu = torch.bfloat16, Activation.RELU
    table = d_net.encoding.grid.detach().to(bf16)
    wd = [w.detach().to(bf16) for w in d_net.network.layers]
    wc = [w.detach().to(bf16) for w in c_net.network.layers]
    pts = torch.rand((B, 3), generator=gen, device=dev)
    dirs = torch.randn((B, 3), generator=gen, device=dev)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    # fit_nerf_field gives every sample of a step one fraction (coarse_to_fine):
    # (i + 1) / 100 at step i < 100, 1.0 for the other 300 steps
    fracs = {f: nf.per_sample_frac(f, B, dev) for f in (1.0, 0.5)}
    t_g = {f: {} for f in fracs}
    t_d, t_c = {}, {}
    consts = L * grid_ops.LEVEL_FIELDS * 4
    pair_flops = grid_flops(spec, 1) // L   # per (sample, level)
    with torch.inference_mode():
        feats = grid_encode_fwd(spec, table, pts, live, soa=True, level_frac=fracs[1.0])
        h = fused_mlp_fwd(wd, feats, relu, Activation.NONE, bf16, torch.float32, True, False)
        cfeat = c_net.encoding(nf.density_heads(h, dirs)[1])
        dh = torch.randn((B, 16), generator=gen, device=dev)   # a gradient into h
        dy_c = torch.randn((B, 3), generator=gen, device=dev)
        dcols = fused_mlp_bwd(wd, feats, dh, relu, Activation.NONE, bf16, True, False)[1]
        g_args, gb_args = (spec, table, pts, live), (spec, table, pts, dcols, live)
        for f, fv in fracs.items():
            t = t_g[f]
            t["G"] = graph_ms(lambda: grid_encode_fwd(*g_args, soa=True, level_frac=fv))
            t["G plain"] = eager_ms(lambda: grid_encode_plain(*g_args, soa=True, level_frac=fv))
            t["GB"] = graph_ms(lambda: grid_encode_bwd(*gb_args, level_frac=fv))
            t["GB plain"] = eager_ms(lambda: grid_encode_bwd_plain(*gb_args, level_frac=fv))
            # Only the live (sample, level) pairs read table rows (G) or
            # output gradients (GB) and compute; G still writes its whole
            # output, GB its whole bf16 table gradient.
            n_live, rows = live_pairs(spec, fv), touched_rows_live(spec, pts, fv)
            print(f"frac {f}:")
            record_bounds(t, {
                "G": (nbytes(pts, fv, feats) + rows * F * 2 + consts, n_live * pair_flops,
                      PEAK_FP32),
                "GB": (nbytes(pts, fv, table) + n_live * F * 2 + consts, n_live * pair_flops,
                       PEAK_FP32)},
                {"G": f" with {rows * F * 2 / 1e6:.2f} MB of table rows the {n_live} live "
                      f"pairs touch",
                 "GB": f", {n_live} of {L * B} (sample, level) pairs live"})
        no_mask = {"G": graph_ms(lambda: grid_encode_fwd(*g_args, soa=True)),
                   "GB": graph_ms(lambda: grid_encode_bwd(*gb_args))}
        for t, ws, x_in, soa, out_act, dy in (
                (t_d, wd, feats, True, Activation.NONE, dh),
                (t_c, wc, cfeat, False, sig, dy_c)):
            m_args = (ws, x_in, relu, out_act, bf16, torch.float32, soa, False)
            mb_args = (ws, x_in, dy, relu, out_act, bf16, soa, False)
            f_in = x_in.t() if soa else x_in
            out = torch.sigmoid if out_act == sig else None
            t["M"] = graph_ms(lambda: fused_mlp_fwd(*m_args))
            t["M plain"] = eager_ms(lambda: fused_mlp_plain(*m_args))
            t["M library"] = graph_ms(lambda: library_chain(ws, f_in, out))
            t["MB"] = graph_ms(lambda: fused_mlp_bwd(*mb_args))
            t["MB plain"] = eager_ms(lambda: fused_mlp_bwd_plain(*mb_args))
            hs = chain_activations(ws, f_in)
            t["MB library"] = graph_ms(lambda: library_bwd(ws, hs, dy))
            dx = fused_mlp_bwd(*mb_args)[1]
            m_flops = 2 * B * sum(w.numel() for w in ws)
            record_bounds(t, {
                "M": (nbytes(x_in, *ws) + B * ws[-1].shape[1] * 4, m_flops, PEAK_BF16),
                "MB": (nbytes(x_in, dy, *ws, dx) + sum(w.numel() for w in ws) * 4,
                       3 * m_flops, PEAK_BF16)})
    print(f"without a mask: G {no_mask['G']:.4f} ms, GB {no_mask['GB']:.4f} ms (frac 1.0: "
          f"{t_g[1.0]['G']:.4f}, {t_g[1.0]['GB']:.4f})")
    opt = create_optimizer(nf.OPTIMIZER)
    opt_state = opt.init(*nf.params_and_layout(d_net, c_net))
    t_step = time_ms(lambda: nf.step(d_net, c_net, opt, opt_state, rays_o, rays_d, NERF_SAMPLES,
                                     jitter, 0.5), n=20)
    t_step_full = time_ms(lambda: nf.step(d_net, c_net, opt, opt_state, rays_o, rays_d,
                                          NERF_SAMPLES, jitter, 1.0), n=20)
    # The step replayed from a CUDA graph is timed in slice 21
    # (compiled_step_slice).
    kernels_ms = {f: t_g[f]["G"] + t_g[f]["GB"] + t_d["M"] + t_d["MB"] + t_c["M"] + t_c["MB"]
                  for f in fracs}
    print(f"NeRF step at B={B}, frac 1.0 (300 of the fit's 400 steps): {t_step_full:.4f} ms "
          f"eager with the host's work ({B / t_step_full * 1e3:.4e} field points/s), the six "
          f"kernels alone {kernels_ms[1.0]:.4f} ms of it: G {t_g[1.0]['G']:.4f}, GB "
          f"{t_g[1.0]['GB']:.4f}, M {t_d['M']:.4f} + {t_c['M']:.4f}, MB {t_d['MB']:.4f} + "
          f"{t_c['MB']:.4f}; frac 0.5: {t_step:.4f} ms, kernels {kernels_ms[0.5]:.4f} ms")
    mlp = {"M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
           "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)"}
    grid = {"G": "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel)",
            "GB": "tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel)"}
    per = {"launches_per_step": per_step}
    return (report_entries(" (nerf, frac 1.0)", t_g[1.0], grid, fit_launches, err, per)
            + report_entries(" (nerf, frac 0.5)", t_g[0.5], grid, fit_launches, err, per)
            + report_entries(" (nerf density 24-64-16)", t_d, mlp, fit_launches, err_d, per)
            + report_entries(" (nerf colour 31-64x2-3 sigmoid)", t_c, mlp, fit_launches,
                             err_c, per))


def image_sample_slice():
    """The image sample, samples/mlp_learning_an_image.py's loop on
    make_training_loop (config_hash, BF16_POLICY, 2^18 samples a step,
    synthetic_image(1024, 1024)), 100 steps into a temporary directory,
    with a PSNR floor."""
    import tempfile

    from tcnn_tpu_torch.samples import mlp_learning_an_image as img

    phase(f"image sample: mlp_learning_an_image.main, {IMAGE_STEPS} steps into a temporary "
          f"directory")
    with tempfile.TemporaryDirectory() as out_dir:
        reset_counts()
        out = img.main(["mlp_learning_an_image", "none", CONFIG, str(IMAGE_STEPS)],
                       out_dir=out_dir)
        torch.cuda.synchronize()
        launches = first_order_counts()
        dumps = sorted(os.listdir(out_dir))
    # the loop's eager warm-up step and its capture; three inferences of the
    # whole 1024^2 image (steps 10, 100 and the end) in chunks of 2^18, the
    # first chunk's request run and captured, the other eleven replayed
    want = {"G": 2 + 2, "M": 2 + 2, "GB": 2, "MB": 2}
    check(launches == want, f"image sample launches {launches}, expected {want}")
    check(bool(torch.isfinite(out["losses"]).all()), "non-finite image sample loss")
    check(len(dumps) == 2, f"image sample dumps {dumps}")
    print(f"image sample: {IMAGE_STEPS} steps in {out['seconds']:.2f} s; PSNR at "
          f"{', '.join(f'{k}: {v:.2f}' for k, v in out['psnr_at'].items())} dB, final "
          f"{out['psnr']:.2f} dB (floor {IMAGE_PSNR_FLOOR}); dumps {dumps}; launches {launches}")
    check(out["psnr"] > IMAGE_PSNR_FLOOR, f"image sample PSNR floor missed: {out['psnr']:.2f}")


# -- slice 9: save, load and serve -----------------------------------------

SERVE_BUCKETS = (1 << 10, 1 << 14, 1 << 16, 1 << 18)
SERVE_REQUESTS = (1, 1000, 1 << 14, 100000, 1 << 18)
TRAIN_STEP_STEPS = 10
LOOP_CHECK_STEPS = 20
EMA_DECAY = 0.99
OPT_STEP_TOL = {"fp32": (1e-5, 1e-6), "Shampoo": (1e-4, 1e-5)}


def new_optimizers(adam):
    """Each optimizer of slice 9 at config_hash, with periods short enough
    for 20 steps to cross them: Batched's (4), Lookahead's (6),
    ExponentialDecay's boundaries (5, 12, 19), Average's ring (8)."""
    return {
        "SGD": {"otype": "SGD", "learning_rate": 1e-1},
        "Novograd": {"otype": "Novograd", "learning_rate": 1e-2},
        "Average": {"otype": "Average", "n_samples": 8, "nested": adam},
        "Batched": {"otype": "Batched", "batch_size_multiplier": 4, "nested": adam},
        "Lookahead": {"otype": "Lookahead", "alpha": 0.5, "n_steps": 6, "nested": adam},
        "ExponentialDecay": {"otype": "ExponentialDecay", "decay_base": 0.5,
                             "decay_start": 5, "decay_end": 19, "decay_interval": 7,
                             "nested": adam},
        "Composite": {"otype": "Composite", "nested": [
            adam, {"otype": "SGD", "learning_rate": 1e-1, "params": "other"}]},
        "Shampoo": {"otype": "Shampoo", "learning_rate": 1e-2},
    }


def leaves_close(got, want, tol, what):
    """Integer leaves equal; float leaves within rtol plus atol·(largest
    magnitude of the leaf); returns the largest relative error."""
    from tcnn_tpu_torch.optimizers.base import named_leaves

    rtol, scale = tol
    worst = 0.0
    g, w = list(named_leaves(got)), list(named_leaves(want))
    check([n for n, _ in g] == [n for n, _ in w], f"{what}: leaf names differ")
    for (name, a), (_, b) in zip(g, w):
        a, b = a.detach().cpu(), b.detach().cpu()
        check(a.shape == b.shape and a.dtype == b.dtype, f"{what} {name}: shape or dtype")
        if not b.is_floating_point():
            check(torch.equal(a, b), f"{what} {name}: integer leaves differ")
            continue
        err = (a - b).abs()
        lim = rtol * b.abs() + scale * max(b.abs().max().item(), 1e-30)
        check(not bool((err > lim).any()), f"{what} {name}: max abs err "
              f"{err.max().item():.3e} beyond rtol {rtol:g} + {scale:g} of the largest")
        worst = max(worst, (err / b.abs().max().clamp_min(1e-30)).max().item())
    return worst


def table_grad_scale(model, x, target):
    """The step's table gradient's S = Σ|w·dy| per entry (GB's atomic
    bound), from the MLP input gradient of the kernel path."""
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd_plain

    enc, net = model.network.encoding, model.network.network
    with torch.enable_grad():
        feats = enc(x, soa=True).detach().requires_grad_()
        (dcols,) = torch.autograd.grad(model.loss(net(feats, input_soa=True).float(), target),
                                       feats)
    table = enc.grid.detach()
    with torch.inference_mode():
        return grid_encode_bwd_plain(enc.spec, table, x, dcols.float().abs(),
                                     list(range(enc.spec.n_levels)))


def check_next_step(label, trainer, original, x, target, scale):
    """One further step's gradients of a restored trainer against the
    original's: the loss bits equal, the weights' gradients bit for bit
    (G, M and MB are deterministic), the table's within GB's atomic bound
    plus one bf16 ulp (GB's fp32 sum is cast once to the bf16 table copy's
    type, and a sum that differs in its last bit may round to the other
    neighbour; the cast back to the fp32 master is exact)."""
    loss, grads = trainer.loss_value_and_grads(x, target)
    want_loss, want = original.loss_value_and_grads(x, target)
    check(torch.equal(loss, want_loss), f"{label}: next-step loss {loss.item()} vs "
          f"{want_loss.item()}")
    for name, g in grads.items():
        if name == "encoding.grid":
            check(torch.equal(g, g.to(torch.bfloat16).float()), f"{label}: {name} "
                  "gradient is not the bf16 copy's")
            err = compare_table_grad(g.to(torch.bfloat16), want[name].to(torch.bfloat16),
                                     scale, f"{label} {name}")
        else:
            check(torch.equal(g, want[name]), f"{label}: {name} gradient bits differ")
            err = 0.0
        print(f"{label}: next step {name} gradient max abs err {err:.3e}")


def save_load_serve_slice(gen, dev, t_hash):
    """Slice 9 on config_hash: EMA(Adam) training, the snapshot,
    serialize and checkpoint round trips, serving from a bundle with a
    graph per bucket, the exported training step, and each new
    optimizer on the card; returns the serving kernels' report entries."""
    import tempfile
    import types

    from tcnn_tpu_torch import BF16_POLICY, create_from_config, load_config, serving
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_fwd
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_fwd
    from tcnn_tpu_torch.optimizers.base import named_leaves
    from tcnn_tpu_torch.tools.plain_path import plain_inference
    from tcnn_tpu_torch.tools.replay_check import (counter_mismatches, nested_interval,
                                                   record_gradients)
    from tcnn_tpu_torch.utils import checkpoint, cuda_export, cuda_import, msgpack
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image
    from tcnn_tpu_torch.utils.metrics import psnr

    base = load_config(CONFIG)
    ema_cfg = {**base, "optimizer": {"otype": "EMA", "decay": EMA_DECAY,
                                     "nested": base["optimizer"]}}
    phase(f"slice 9: config_hash with EMA(Adam) (decay {EMA_DECAY}), {FIT_STEPS} steps of "
          f"make_training_loop at B={MAIN_BATCH} on synthetic_image(1024, 1024)")
    fit = create_from_config(2, 3, ema_cfg, policy=BF16_POLICY)
    sampler = ImageSampler(synthetic_image(1024, 1024), seed=0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    losses = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                            FIT_STEPS)()
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    train_launches = first_order_counts()
    check(train_launches == {"G": 2, "M": 2, "GB": 2, "MB": 2},
          f"EMA training path launches {train_launches}, expected 2 of each (warm-up, capture)")
    losses = losses.cpu()
    check(bool(torch.isfinite(losses).all()), "non-finite EMA training loss")
    coords = sampler.full_grid_coords()
    ema_psnr = psnr(fit.trainer.inference(coords), sampler.image.reshape(-1, 3))
    with torch.inference_mode():
        raw_psnr = psnr(fit.network.inference(coords), sampler.image.reshape(-1, 3))
    x = torch.rand((MAIN_BATCH, 2), generator=gen, device=dev)
    target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
    y_ema = fit.trainer.inference(x)
    with torch.inference_mode():
        y_raw = fit.network.inference(x)
    print(f"EMA(Adam): {FIT_STEPS} steps in {fit_s:.2f} s; loss {float(losses[0]):.4f} -> "
          f"{float(losses[-10:].mean()):.4f}; PSNR {ema_psnr:.2f} dB with the EMA weights, "
          f"{raw_psnr:.2f} dB with the raw ones; launches {train_launches}")
    check(ema_psnr > 20.0, f"EMA PSNR floor missed: {ema_psnr:.2f} dB")
    check(not torch.equal(y_ema, y_raw), "EMA inference equals the raw parameters' inference")

    phase("slice 9: snapshot export -> the port's msgpack codec -> import_params on the card")
    snap = msgpack.unpackb(msgpack.packb(cuda_export.export_snapshot(fit.trainer)))
    fresh = create_from_config(2, 3, CONFIG, policy=BF16_POLICY, seed=5)
    cuda_import.import_params(fresh.network, snap)
    check(torch.equal(fresh.trainer.inference(x), y_raw),
          "snapshot round trip: inference bits differ from the raw parameters'")
    print(f"snapshot: {snap['n_params']} params, {len(msgpack.packb(snap))} msgpack bytes; "
          f"inference bits equal at B={MAIN_BATCH}")

    phase("slice 9: serialize -> deserialize and save_checkpoint -> restore_checkpoint")
    t0 = time.time()
    data = json.loads(json.dumps(fit.trainer.serialize()))
    ser_s = time.time() - t0
    by_ser = create_from_config(2, 3, ema_cfg, policy=BF16_POLICY, seed=6)
    t0 = time.time()
    by_ser.trainer.deserialize(data)
    deser_s = time.time() - t0
    by_ckpt = create_from_config(2, 3, ema_cfg, policy=BF16_POLICY, seed=7)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        checkpoint.save_checkpoint(os.path.join(d, "ck"), fit.trainer)
        save_s = time.time() - t0
        t0 = time.time()
        checkpoint.restore_checkpoint(os.path.join(d, "ck"), like=by_ckpt.trainer)
        restore_s = time.time() - t0
    scale = table_grad_scale(fit, x, target)
    for label, restored in (("deserialized", by_ser), ("checkpoint", by_ckpt)):
        check(restored.trainer.step == fit.trainer.step, f"{label}: step")
        check(torch.equal(restored.trainer.inference(x), y_ema),
              f"{label}: inference bits differ from the trained trainer's")
        check_next_step(label, restored.trainer, fit.trainer, x, target, scale)
    print(f"serialize {ser_s:.2f} s ({len(json.dumps(data)) / 1e6:.1f} MB of JSON), "
          f"deserialize {deser_s:.2f} s; save_checkpoint {save_s:.2f} s, restore "
          f"{restore_s:.2f} s; both restored trainers give the inference bits")

    phase(f"slice 9: serving bundle at buckets {SERVE_BUCKETS}, loaded on the card")
    bundle = serving.export_inference(fit.trainer, batch_sizes=SERVE_BUCKETS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    srv = serving.load_inference(bundle)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    capture_launches = first_order_counts()
    want = {"G": len(SERVE_BUCKETS) + 1, "M": len(SERVE_BUCKETS) + 1, "GB": 0, "MB": 0}
    check(capture_launches == want, f"serving capture launches {capture_launches}, expected "
          f"{want} (one warm-up request, then one capture per bucket)")
    serve_errs = {}
    for b in SERVE_REQUESTS:
        xb = torch.rand((b, 2), generator=gen, device=dev)
        before = counts()
        got = srv(xb)
        torch.cuda.synchronize()
        check(counts() == before, f"a served request of {b} rows called a kernel wrapper: "
              "a request must replay its bucket's graph")
        check(torch.equal(got, fit.trainer.inference(xb)),
              f"served request of {b} rows: bits differ from Trainer.inference")
        with torch.inference_mode():
            plain = plain_inference(types.SimpleNamespace(network=srv.model), xb)
        serve_errs[b] = compare(got, plain, "model")[0]
        print(f"request of {b} rows (bucket {srv.bucket_for(b)}): bits of "
              f"Trainer.inference; max abs err {serve_errs[b]:.3e} vs the plain path "
              f"(rtol 2e-2, atol 2e-3)")
    print(f"bundle {len(bundle) / 1e6:.2f} MB; load_inference {load_s:.2f} s (build of the "
          f"model and {len(SERVE_BUCKETS)} graphs); launches at capture {capture_launches}")
    serve_t = {}
    for b in SERVE_BUCKETS:
        xb = torch.rand((b, 2), generator=gen, device=dev)
        replay = srv._graphs[b].graph.replay
        serve_t[b] = {"request": time_ms(lambda: srv(xb)), "device": time_ms(replay),
                      "inference": time_ms(lambda: fit.trainer.inference(xb)),
                      "inference device": graph_ms(lambda: fit.trainer.inference(xb))}
        v = serve_t[b]
        print(f"bucket {b}: served request {v['request']:.4f} ms with the host's work, "
              f"graph replay {v['device']:.4f} ms; Trainer.inference {v['inference']:.4f} ms, "
              f"{v['inference device']:.4f} ms of device work")
    top = SERVE_BUCKETS[-1]
    print(f"served samples/s at {top}: {top / serve_t[top]['request'] * 1e3:.4e} "
          f"(Trainer.inference {top / serve_t[top]['inference'] * 1e3:.4e})")

    phase(f"slice 9: export_train_step at B={MAIN_BATCH} -> load_train_step, "
          f"{TRAIN_STEP_STEPS} steps against training_step")
    step = serving.load_train_step(serving.export_train_step(fit.trainer, MAIN_BATCH))
    live = create_from_config(2, 3, ema_cfg, policy=BF16_POLICY, seed=8)
    state = fit.trainer.serialize()
    live.trainer.deserialize(state)
    batches = [sampler.sample_batch(MAIN_BATCH) for _ in range(TRAIN_STEP_STEPS)]
    t0 = time.time()
    got = []
    for xb, tb in batches:
        state, loss = step(state, xb, tb)
        got.append(loss)
    got = torch.stack(got)
    torch.cuda.synchronize()
    aot_s = time.time() - t0
    want_l = torch.stack([live.trainer.training_step(xb, tb) for xb, tb in batches])
    torch.cuda.synchronize()
    rel = ((got - want_l).abs() / want_l.abs()).max().item()
    check(rel <= 1e-3, f"exported step losses {got.tolist()} vs {want_l.tolist()}")
    check(state["step"] == live.trainer.step, "exported step count")
    print(f"exported step: {TRAIN_STEP_STEPS} steps in {aot_s:.2f} s (the trainer dict "
          f"read and written each step); losses within {rel:.2e} of training_step's "
          f"(rtol 1e-3; GB's atomics)")

    phase("slice 9: each new optimizer on the card: a step against the CPU's, "
          f"{LOOP_CHECK_STEPS} replayed steps against eager ones, the optimizer's step time")
    opt_t = {}
    adam_model = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
    _, adam_grads = adam_model.trainer.loss_value_and_grads(x, target)
    opt_t["Adam"] = graph_ms(lambda: adam_model.optimizer.step(
        adam_model.trainer.opt_state, adam_grads, adam_model.trainer.params()))
    for name, ocfg in new_optimizers(base["optimizer"]).items():
        cfg = {**base, "optimizer": ocfg}
        card = create_from_config(2, 3, cfg, policy=BF16_POLICY)
        for xb, tb in batches[:2]:
            card.trainer.training_step(xb, tb)
        cpu = create_from_config(2, 3, cfg, policy=BF16_POLICY, device="cpu")
        with torch.no_grad():
            for (_, dst), (_, src) in zip(named_leaves(cpu.trainer.params()),
                                          named_leaves(card.trainer.params())):
                dst.copy_(src.cpu())
            for (_, dst), (_, src) in zip(named_leaves(cpu.trainer.opt_state),
                                          named_leaves(card.trainer.opt_state)):
                dst.copy_(src.cpu())
        _, grads = card.trainer.loss_value_and_grads(x, target)
        card.optimizer.step(card.trainer.opt_state, grads, card.trainer.params())
        cpu.optimizer.step(cpu.trainer.opt_state, {n: g.cpu() for n, g in grads.items()},
                           cpu.trainer.params())
        torch.cuda.synchronize()
        tol = OPT_STEP_TOL["Shampoo" if name == "Shampoo" else "fp32"]
        err = max(leaves_close(card.trainer.params(), cpu.trainer.params(), tol, name),
                  leaves_close(card.trainer.opt_state, cpu.trainer.opt_state, tol, name))
        line = f"{name}: one step on the card vs the CPU, max rel err {err:.2e} (rtol {tol[0]:g})"
        if name == "Shampoo":   # kernel SR's roots at the refresh of t = 10
            line += (f"; roots refreshed at t = 10 against float64 roots of the same "
                     f"matrices: largest error {shampoo_roots_against_f64(card, batches):.3e} "
                     f"of the root's largest entry (ROOT_TOL 32 ulps)")
        opt_t[name] = graph_ms(lambda: card.optimizer.step(
            card.trainer.opt_state, grads, card.trainer.params()))
        pair = [create_from_config(2, 3, cfg, policy=BF16_POLICY) for _ in range(2)]
        rec = [record_gradients(m.trainer, LOOP_CHECK_STEPS) for m in pair]
        replayed = pair[0].trainer.make_training_loop(
            lambda i: batches[i % len(batches)], LOOP_CHECK_STEPS)()
        eager = torch.stack([pair[1].trainer.training_step(*batches[i % len(batches)])
                             for i in range(LOOP_CHECK_STEPS)])
        torch.cuda.synchronize()
        rel = ((replayed - eager).abs() / eager.abs()).max().item()
        check(rel <= 1e-3, f"{name}: replayed losses {replayed.tolist()} vs eager "
              f"{eager.tolist()}")
        check([int(i) for _, i in rec] == [LOOP_CHECK_STEPS] * 2,
              f"{name}: recorded {[int(i) for _, i in rec]} steps' gradients")
        n_ints = sum(1 for n, t in named_leaves(pair[1].trainer.opt_state)
                     if not t.is_floating_point() or n.endswith("factor"))
        failed, odd = counter_mismatches(pair[0].trainer.opt_state, pair[1].trainer.opt_state,
                                         rec[0][0], rec[1][0],
                                         nested_interval(pair[0].optimizer))
        check(not failed, f"{name}: replayed state differs from eager: {failed}; {odd}")
        print(f"{line}; {LOOP_CHECK_STEPS} replayed steps' losses within {rel:.2e} of eager "
              f"(rtol 1e-3), counters and factors equal ({n_ints} leaves"
              + (f"; but for {len(odd)} lazy counter entries, each its own gradients' "
                 f"count: {odd}" if odd else "")
              + f"); step {opt_t[name]:.4f} ms on the device")
    print("optimizer step alone at config_hash, device ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in opt_t.items()))

    # The serving path's kernels: G and M as the bucket graphs launch them
    # (config_hash at B = 2^18, timed in config_hash's slice on the same
    # shapes), launched once per bucket at capture and once in the warm-up.
    replaces = {
        "G": "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel)",
        "M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)"}
    return report_entries(" (serving graphs)", t_hash, replaces, capture_launches,
                          {"G": serve_errs[top], "M": serve_errs[top]},
                          {"served_request_ms": {k: serve_t[top]["request"] for k in replaces},
                           "served_replay_ms": {k: serve_t[top]["device"] for k in replaces}})


def shampoo_roots_against_f64(model, batches):
    """Steps a Shampoo model on to t = 10, a root refresh, and holds each
    refreshed root against the float64 root of the same float32 S within
    ``ROOT_TOL``; returns the largest ``root_error``."""
    from tcnn_tpu_torch.tools.plain_path import ROOT_TOL, root_error

    opt = model.optimizer
    for xb, tb in batches[int(model.trainer.opt_state["step"]):10]:
        model.trainer.training_step(xb, tb)
    check(int(model.trainer.opt_state["step"]) == 10, "Shampoo: not at t = 10")
    worst = 0.0
    for name, st in model.trainer.opt_state["mat"].items():
        for k in ("L", "R") if st else ():
            err = root_error(st[k + "_root"], st[k], opt.identity_strength)
            check(err <= ROOT_TOL, f"Shampoo {name} {k}_root: error {err:.3e} beyond "
                  f"{ROOT_TOL:.3e}")
            worst = max(worst, err)
    return worst


# -- slice 10: the tinycudann torch modules ---------------------------------

# The JAX sample through the JAX bindings (`python
# samples/mlp_learning_an_image_pytorch.py none 1000` on the CPU: fp32,
# 1000 steps of 2^14 pixels of benchmarks/data/fixture.png) read PSNR@1000
# 40.95 dB; the floor is 3 dB below it.
IMAGE_PT_PSNR_JAX = 40.95
IMAGE_PT_PSNR_FLOOR = IMAGE_PT_PSNR_JAX - 3.0
IMAGE_PT_STEPS = 1000
IMAGE_PT_BATCH_POW = 14


def relative_l2(pred, target):
    """The image sample's manual relative L2 (the original torch sample's)."""
    return ((pred - target) ** 2 / (pred.detach() ** 2 + 0.01)).mean()


def leaves_of(module, flat):
    """{parameter name: its part of a binding module's flat vector}."""
    return {leaf.name: v for leaf, v in zip(module._leaves, module._split(flat))}


def binding_first_order(m, x, target):
    """One forward and backward of the binding ``m`` (a grid into a fused
    MLP, fp32) on x, the relative L2 against target, against its plain
    path on the same tensors: the output within the fp32 MLP bound,
    params.grad leaf by leaf (the table per entry within 2^-11·S, the
    weights within 1e-4 of their largest magnitude) and the input
    gradient within 1e-4 of its largest magnitude (it sums kernel MB's
    dx, itself within 1e-4).  MB's dx rows that a switched fp32 ReLU
    explains take their flipped variants on the plain side, as in the
    eikonal step.  Returns the launches and the errors by kernel."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_fwd, fused_mlp_plain)
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd_input_plain,
                                                     grid_encode_bwd_plain, grid_encode_fwd,
                                                     grid_encode_plain)

    enc, net = m.native.encoding, m.native.network
    spec, live = enc.spec, list(range(enc.spec.n_levels))
    xg = x.clone().requires_grad_()
    m.params.grad = None
    reset_counts()
    y = m(xg)
    relative_l2(y, target).backward()
    torch.cuda.synchronize()
    launches = counts()

    f32, relu, none = torch.float32, net.activation, net.output_activation
    table = enc.grid.detach()
    ws = [w.detach() for w in net.layers]
    with torch.no_grad():
        feats = grid_encode_plain(spec, table, x, live, soa=True)
        y_plain = fused_mlp_plain(ws, feats, relu, none, f32, f32, True, False)
        k_feats = grid_encode_fwd(spec, table, x, live, soa=True)
        k_y = fused_mlp_fwd(ws, k_feats, relu, none, f32, f32, True, False)
    dy, k_dy = (torch.autograd.grad(relative_l2(p.requires_grad_(), target), p)[0]
                for p in (y_plain.clone(), k_y.clone()))
    with torch.no_grad():
        dws, dfeats = fused_mlp_bwd_plain(ws, feats, dy, relu, none, f32, True, False)
        k_dx = fused_mlp_bwd(ws, k_feats, k_dy, relu, none, f32, True, False)[1]
    _, rows, variants = compare_input_grad(k_dx, dfeats, ws, feats, dy, none, soa_in=True,
                                           what="binding MB dx", dtype=f32)
    dfeats = dfeats.clone()
    dfeats.t()[rows] = variants
    with torch.no_grad():
        dtable = grid_encode_bwd_plain(spec, table, x, dfeats, live)
        scale = grid_encode_bwd_plain(spec, table, x, dfeats.abs(), live)
        dx = grid_encode_bwd_input_plain(spec, table, x, dfeats, live)
    grads = leaves_of(m, m.params.grad)
    err = {"M": compare(y.detach(), y_plain, "mlp-f32")[0],
           "GB": compare_table_grad(grads["encoding.grid"], dtable, scale, "binding table grad"),
           "MB": compare_mlp_grads([grads[f"network.layers.{i}"] for i in range(len(ws))], dws,
                                   f32, "binding weight grads"),
           "GI": compare_rel(xg.grad, dx, 1e-4, "binding input grad")}
    with torch.no_grad():
        err["G"] = compare(k_feats, feats, "grid-f32")[0]
    print(f"binding first order at B={x.shape[0]}: output max abs err {err['M']:.3e} "
          f"(1e-5·|ref| + 1e-5), table grad {err['GB']:.3e} (2^-11·S), weight grads "
          f"{err['MB']:.3e} (1e-4 of their max), input grad {err['GI']:.3e} (1e-4 of its max); "
          f"{rows.numel()} MB dx rows explained by a switched ReLU; launches {launches}")
    return launches, err


def bindings_slice(gen, dev):
    """Slice 10: tiny-cuda-nn's torch modules (``bindings.torch_interop``)
    on the card.  A NetworkWithInputEncoding at config_hash's full width
    (fp32, B = 2^18): forward and first order against the plain path; the
    SDF sample's eikonal step through a NetworkWithInputEncoding at its
    grid (double backward: GI, GG; no GB under ``autograd.grad(y,
    x)``) against the plain eikonal step; ``Encoding(dtype=float16)``;
    a pickle round trip; the ported image sample at the JAX sample's
    settings, the main path, with a PSNR floor; and the binding's eager
    step beside ``make_training_loop``'s on the same model.  Returns the
    report entries."""
    import pickle
    import tempfile

    from tcnn_tpu_torch import DEFAULT_POLICY, create_from_config, load_config
    from tcnn_tpu_torch.bindings import torch_interop as ti
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_plain
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
    from tcnn_tpu_torch.samples import mlp_learning_an_image_pytorch as img_pt
    from tcnn_tpu_torch.tools.plain_path import plain_sdf_loss_and_grads

    t_slice = time.time()
    cfg = load_config(CONFIG)
    m = ti.NetworkWithInputEncoding(2, 3, cfg["encoding"], cfg["network"])
    enc, net = m.native.encoding, m.native.network
    spec = enc.spec
    check(spec.n_dims == 2 and spec.n_levels == 16 and spec.n_features_per_level == 2
          and max(lv.size for lv in spec.levels) == 1 << 15
          and [tuple(w.shape) for w in net.layers] == mlp_dims(32, 64, 2),
          f"binding at config_hash: {spec.n_dims}-D, {spec.n_levels} levels, "
          f"{[tuple(w.shape) for w in net.layers]}")
    with torch.no_grad():   # O(1) features, as in the other slices' checks
        leaves_of(m, m.params)["encoding.grid"].uniform_(-1, 1, generator=gen)
    print(f"{m}: {m.params.numel()} parameters in one flat fp32 vector, "
          f"leaves {[leaf.name for leaf in m._leaves]}")
    B = MAIN_BATCH
    x = torch.rand((B, 2), generator=gen, device=dev)
    target = torch.rand((B, 3), generator=gen, device=dev)

    phase(f"slice 10: bindings NetworkWithInputEncoding at config_hash (fp32), B={B}: "
          f"forward, params.grad and the input gradient vs the plain path")
    launches, err = binding_first_order(m, x, target)
    want = {"G": 1, "M": 1, "GB": 1, "MB": 1, "GI": 1, "GG": 0, "RS": 0, "GT": 0, "MW": 0,
            "MBW": 0}
    check(launches == want, f"binding first-order launches {launches}, expected {want}")

    phase(f"slice 10: the SDF sample's eikonal step through bindings "
          f"NetworkWithInputEncoding at B={B}, vs the plain eikonal step")
    s = ti.NetworkWithInputEncoding(3, 1, sdf.CONFIG["encoding"], sdf.CONFIG["network"])
    with torch.no_grad():
        leaves_of(s, s.params)["encoding.grid"].uniform_(-1, 1, generator=gen)
    xs, xv = sdf.sample_points(gen, B, dev)
    xg = xv.clone().requires_grad_()
    reset_counts()
    (dydx,) = torch.autograd.grad(s(xg).sum(), xg)
    torch.cuda.synchronize()
    ig_launches = counts()
    want = {"G": 1, "M": 1, "GB": 0, "MB": 1, "GI": 1, "GG": 0, "RS": 0, "GT": 0, "MW": 0,
            "MBW": 0}
    check(ig_launches == want, f"binding autograd.grad(y, x) launches {ig_launches}: "
          f"expected {want} (no GB: the table gradient would be thrown away)")
    check(dydx.shape == (B, 3) and bool(torch.isfinite(dydx).all()), "binding input gradient")
    reset_counts()
    loss = sdf.loss_fn(s, xs, xv)[0]
    loss.backward()
    torch.cuda.synchronize()
    step_launches = counts()
    per_step = {"G": 2, "M": 2, "MB": 2, "GB": 1, "GI": 1, "GG": 1, "RS": 0, "GT": 0,
                "MW": 0, "MBW": 0}
    check(step_launches == per_step, f"binding eikonal step launches {step_launches}, "
          f"expected {per_step}")
    want_loss, want, scale = plain_sdf_loss_and_grads(
        s.native, xs, xv, table_scale=True, mlp_bwd=sdf_flip_explained_bwd(s.native, xs, xv))
    check(abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item()),
          f"binding eikonal loss {loss.item()} vs plain {want_loss.item()}")
    grads = leaves_of(s, s.params.grad)
    check(set(grads) == set(want), f"binding gradient names {sorted(grads)}")
    for name in grads:
        if name == "encoding.grid":
            e, how = compare_table_grad(grads[name], want[name], scale), "2^-11·S per entry"
        else:
            e, how = compare_rel(grads[name], want[name], 1e-4, name), "1e-4 of its max"
        print(f"binding eikonal gradient {name}: max abs err {e:.3e} vs the plain step "
              f"({how})")
    print(f"binding eikonal step: loss {loss.item():.6f}, plain {want_loss.item():.6f}; "
          f"launches {step_launches}; autograd.grad(y, x) alone {ig_launches}")

    phase("slice 10: Encoding(dtype=torch.float16) at config_hash's grid; a pickle round trip")
    e16 = ti.Encoding(2, cfg["encoding"], dtype=torch.float16)
    with torch.no_grad():
        e16.params.copy_(leaves_of(m, m.params)["encoding.grid"])
        reset_counts()
        y16 = e16(x)
        torch.cuda.synchronize()
        enc_launches = counts()
        ref = grid_encode_plain(spec, enc.grid.detach(), x, list(range(spec.n_levels)))
    check(enc_launches["G"] == 1 and sum(enc_launches.values()) == 1,
          f"Encoding launches {enc_launches}")
    check(y16.dtype == torch.float16 and y16.shape == ref.shape, f"Encoding output "
          f"{y16.dtype} {tuple(y16.shape)}")
    ulp16 = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -14))) - 10)
    e_half = (y16.float() - ref).abs()
    check(bool((e_half <= ulp16).all()), f"Encoding fp16: {int((e_half > ulp16).sum())} "
          f"values beyond one fp16 ulp of the plain fp32 output")
    with torch.no_grad():
        y0 = m(x)
        m2 = pickle.loads(pickle.dumps(m))
        check(m2.params.device == m.params.device and torch.equal(m2(x), y0),
              "pickle round trip: output bits differ")
    print(f"Encoding fp16: max abs err {e_half.max().item():.3e} (one fp16 ulp of the plain "
          f"fp32 output); pickle round trip: output equal bit for bit")

    phase(f"slice 10: the image sample through the bindings, mlp_learning_an_image_pytorch."
          f"main, {IMAGE_PT_STEPS} steps at 2^{IMAGE_PT_BATCH_POW} into a temporary directory")
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        reset_counts()
        out = img_pt.main(["mlp_learning_an_image_pytorch", "none", str(IMAGE_PT_STEPS),
                           str(IMAGE_PT_BATCH_POW)], out_dir=out_dir)
        torch.cuda.synchronize()
        sample_launches = counts()
        dumps = sorted(os.listdir(out_dir))
    n_dumps = len(out["psnr_at"])
    want = {"G": IMAGE_PT_STEPS + n_dumps, "M": IMAGE_PT_STEPS + n_dumps, "GB": IMAGE_PT_STEPS,
            "MB": IMAGE_PT_STEPS, "GI": 0, "GG": 0, "RS": 0, "GT": 0, "MW": 0, "MBW": 0}
    check(sample_launches == want, f"image sample (bindings) launches {sample_launches}, "
          f"expected {want}")
    check(bool(torch.isfinite(out["losses"]).all()), "non-finite loss in the bindings sample")
    psnr_end = out["psnr_at"].get(IMAGE_PT_STEPS, float("nan"))
    print(f"bindings image sample: {IMAGE_PT_STEPS} steps in {out['seconds']:.2f} s "
          f"({out['seconds'] / IMAGE_PT_STEPS * 1e3:.4f} ms per eager step); PSNR "
          + ", ".join(f"@{k}: {v:.2f}" for k, v in out["psnr_at"].items())
          + f" dB (floor {IMAGE_PT_PSNR_FLOOR:.2f}); dumps {dumps}; launches {sample_launches}")
    check(psnr_end >= IMAGE_PT_PSNR_FLOOR,
          f"bindings image sample PSNR floor missed: {psnr_end:.2f} < {IMAGE_PT_PSNR_FLOOR:.2f}")

    phase(f"slice 10 times at B={B}: the binding's eager step (forward, relative L2, "
          f"backward, torch.optim.Adam) beside make_training_loop's on the same model")
    opt = torch.optim.Adam(m.parameters(), lr=0.01)

    def binding_step():
        opt.zero_grad()
        loss = relative_l2(m(x), target)
        loss.backward()
        opt.step()
        return loss

    t_bind = time_ms(binding_step)
    model = create_from_config(2, 3, CONFIG, policy=DEFAULT_POLICY)
    with torch.no_grad():
        native = dict(m.native.named_parameters())
        for name, p in model.network.named_parameters():
            p.copy_(native[name])
    loop = model.trainer.make_training_loop(lambda i: (x, target), LOOP_STEPS)
    t = slice_times("config_hash fp32 (the bindings' model)", model, x, target, loop)
    print(f"binding eager step at B={B}: {t_bind:.4f} ms (median of {N_TIMED}, CUDA events); "
          f"the trainer on the same model (config_hash's RelativeL2 and Adam, fp32): "
          f"make_training_loop {t['loop step']:.4f} ms per step, eager training_step "
          f"{t['step']:.4f} ms, {t['step device']:.4f} ms of device work")
    print(f"slice 10: {time.time() - t_slice:.1f} s")
    replaces = {
        "G": "tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel); "
             "tcnn_tpu/ops/pallas/grid_matmul.py:734 (_gather_kernel_xor)",
        "M": "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)",
        "GB": "tcnn_tpu/ops/pallas/grid_matmul.py:602 (_scatter_kernel_xor); "
              "tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel)",
        "MB": "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)"}
    # launches: the sample's counts (slice 10's main path); the first-order
    # and eikonal checks' counts beside them
    return report_entries(" (bindings)", t, replaces, sample_launches, err,
                          {"launches_first_order": launches,
                           "launches_eikonal_step": step_launches})


# Slice 11: what the port once refused and the JAX package computes.
RNG_STEPS = 200
WIDE_BATCH = {5: 1 << 15, 7: 1 << 13}   # 2^D corners a sample: smaller batches at 5 and 7 dims
WIDE_EIKONAL_DRAWS = 20                  # 7-D eikonal steps, each on its own weights and points
DEEP_HIDDEN = 12                         # FullyFusedMLP 128 wide: MB in two launches
JACREV_ROWS = 4                          # jacrev of the first rows' outputs at 2^18
REPLACES_G = ("tcnn_tpu/ops/pallas/grid_matmul.py:861 (_gather_kernel); "
              "tcnn_tpu/ops/pallas/grid_matmul.py:734 (_gather_kernel_xor)")
REPLACES_GB = ("tcnn_tpu/ops/pallas/grid_matmul.py:204 (_scatter_kernel); "
               "tcnn_tpu/ops/pallas/grid_matmul.py:602 (_scatter_kernel_xor); "
               "tcnn_tpu/ops/pallas/scatter.py:392 (_weighted_kernel)")
REPLACES_GI = ("none (jnp): tcnn_tpu/ops/grid_ops.py:1104 (_finish_interp_bwd) and "
               "autodiff of tcnn_tpu/ops/grid_ops.py:476 (_build_indices_weights)")
REPLACES_GG = ("none (jnp): autodiff of tcnn_tpu/ops/grid_ops.py:1094 "
               "(_finish_interp_bwd) and of tcnn_tpu/ops/grid_ops.py:476")
REPLACES_MB = "tcnn_tpu/ops/pallas/fused_mlp.py:113 (_bwd_kernel)"


def rng_hash_ops(spec, x, picks=None):
    """Integer operations of the Rng hashes the batch x needs: per hashed
    (sample, level, corner), 7 per set bit of the corner's 64-bit step (two
    64-bit products and an add, in 32-bit multiply-adds) and 12 for the
    step and the output.  ``picks`` (L, B): one corner per (sample, level),
    stochastic interpolation's, the only one GB hashes."""
    D, nbits, ops = spec.n_dims, 64 // spec.n_dims, 0
    for l, lv in enumerate(spec.levels):
        if not lv.use_hash:
            continue
        pos = x * np.float32(lv.scale) + 0.5
        cells = torch.floor(pos).long() & 0xFFFFFFFF
        for c in range(1 << D):
            step = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
            for d in range(D):
                step ^= ((cells[:, d] + ((c >> d) & 1)) & 0xFFFFFFFF) << (d * nbits)
            bits = sum(((step >> j) & 1) for j in range(64))
            keep = 1 if picks is None else (picks[l] == c).long()
            ops += int(((7 * bits + 12) * keep).sum())
    return ops


def corner_flops(spec, batch):
    """Per (sample, level): positions and weights (kernel GI)."""
    D, C = spec.n_dims, 1 << spec.n_dims
    return batch * spec.n_levels * (4 * D + C * (D - 1))


def gi_flops(spec, batch):
    """GI: per corner the row's dot with dcols (2F), d w / dx (D·D), dx += (2D)."""
    D, C, F = spec.n_dims, 1 << spec.n_dims, spec.n_features_per_level
    return corner_flops(spec, batch) + batch * spec.n_levels * C * (2 * F + D * D + 2 * D)


def gg_flops(spec, batch):
    """GG: per (sample, level) the positions and the per-dim factors and
    their derivatives (4D); per corner w' and the Hessian times ddx, by
    the fewer of two algorithms' operations: forward mode's prefix (5D)
    and suffix (11D, p·f' shared with the prefix) products (grid_common.cuh,
    dir_grad_hess: GG's), or the expanded products, d w / dx (D·D), w'
    (2D) and the Hessian's (D^3 + D·D), fewer at D <= 2; then d dcols
    (2F), the row's dot with dcols (2F), d_x's sum (2D), the table
    gradient's w'·dy and its add (2F)."""
    D, C, F = spec.n_dims, 1 << spec.n_dims, spec.n_features_per_level
    hess = min(16 * D, D ** 3 + 2 * D * D + 2 * D)
    return batch * spec.n_levels * (4 * D + C * (hess + 2 * D + 6 * F))


def check_second_order(spec, table, x, dcols, ddx, live, frac=None, shard=None, label=""):
    """Kernel GG against its plain version: d_dcols and d_x within 1e-5 of
    each one's largest magnitude and bit for bit in a second launch (one
    writer per (sample, level), the levels summed in one order); the table
    gradient per entry within 2^-11·S, S over the terms of its updates
    (``plain_path.gg_table_scale``; Σ|g| is not sound where a g's terms
    cancel), plus one bf16 ulp for bf16 tables.  Returns (max abs err of
    d_dcols and d_x, that of the table gradient)."""
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd_bwd, grid_encode_bwd_bwd_plain
    from tcnn_tpu_torch.tools.plain_path import gg_table_scale

    with torch.inference_mode():
        got = grid_encode_bwd_bwd(spec, table, x, dcols, ddx, live, level_frac=frac, shard=shard)
        again = grid_encode_bwd_bwd(spec, table, x, dcols, ddx, live, level_frac=frac,
                                    shard=shard)
        torch.cuda.synchronize()
        check(torch.equal(got.d_dcols, again.d_dcols) and torch.equal(got.d_x, again.d_x),
              f"GG {label}: d_dcols or d_x differ between two launches")
        want = grid_encode_bwd_bwd_plain(spec, table, x, dcols, ddx, live, level_frac=frac,
                                         shard=shard)
        e = max(compare_rel(got.d_dcols, want.d_dcols, 1e-5, f"GG {label} d_dcols"),
                compare_rel(got.d_x, want.d_x, 1e-5, f"GG {label} d_x"))
        scale = gg_table_scale(spec, x, dcols, ddx, live, frac, shard)
        e_flat = compare_table_grad(got.d_flat, want.d_flat, scale, f"GG {label} table grad")
        check(not bool(got.d_flat[scale == 0].any()),
              f"GG {label}: table rows no update reaches are not zero")
    return e, e_flat


def plain_net(net, params, x):
    """The model's forward through the plain versions, as a function of its
    parameters (torch operations: torch.func and autograd differentiate it
    to any order)."""
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_plain
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_plain

    enc, mlp, pol = net.encoding, net.network, net.policy
    spec, cdt = enc.spec, pol.compute_dtype
    feats = grid_encode_plain(spec, params["encoding.grid"].to(cdt), x,
                              list(range(spec.n_levels)), soa=True).to(cdt)
    return fused_mlp_plain([params[f"network.layers.{i}"] for i in range(len(mlp.layers))],
                           feats, mlp.activation, mlp.output_activation, cdt, pol.output_dtype,
                           input_soa=True)


def eikonal_grads(f, params, xs, xv):
    """The SDF sample's loss (surface term and eikonal term) of the function
    f and its gradients in ``params``."""
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf

    xv = xv.detach().requires_grad_()
    surf = torch.mean(f(xs)[:, 0] ** 2)
    (gx,) = torch.autograd.grad(f(xv)[:, 0].sum(), xv, create_graph=True)
    loss = surf + sdf.EIKONAL_WEIGHT * sdf.eikonal_loss(gx)
    return loss.detach(), torch.autograd.grad(loss, params)


def check_eikonal_step(net, xs, xv, frac, what, expect=None, table_rel=None):
    """One eikonal step through the kernels (the main path: counts set to 0
    before it, read after) against the same step through the plain versions
    (``plain_sdf_loss_and_grads``, MB's rows that a switched ReLU explains
    substituted, as in slice 4): loss at 1e-4 relative, the table gradient
    per entry within 2^-11·S (GB's and GG's atomics), every weight gradient
    within 1e-4 of its largest magnitude (fp32).  ``table_rel``: the table
    gradient within that share of its largest magnitude, as the curvature
    step holds it (the entries beyond 2^-11·S are counted and printed), and
    per entry within 2^-11·S against the plain step run on kernel MB's dx:
    the per-entry bound holds where both paths share the grid's output
    gradient, and MB's dx, within its own bound, cancels to a few ulps of
    its terms in some samples.  ``expect``: the step's launches
    (None: the shallow MLP's, one launch of M and MB each).  Returns the
    step's launches."""
    from tcnn_tpu_torch.tools.plain_path import plain_sdf_loss_and_grads

    names = [n for n, _ in net.named_parameters()]
    kw = {} if frac is None else {"max_level_per_element": frac}
    torch.cuda.synchronize()
    reset_counts()
    loss, grads = eikonal_grads(lambda x: net(x, **kw), list(net.parameters()), xs, xv)
    torch.cuda.synchronize()
    launches = counts()
    want_loss, want, scale = plain_sdf_loss_and_grads(
        net, xs, xv, table_scale=True, mlp_bwd=sdf_flip_explained_bwd(net, xs, xv, frac),
        level_frac=frac)
    check(abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item()),
          f"{what}: loss {loss.item()} vs plain {want_loss.item()}")
    check(sorted(want) == sorted(names), f"{what}: gradient names {sorted(want)}")
    hows = []
    for n, g in zip(names, grads):
        if n == "encoding.grid" and table_rel:
            e = compare_rel(g, want[n], table_rel, f"{what} {n}")
            over = int(((g - want[n]).abs() > 2.0 ** -11 * scale).sum())
            # the plain step again on kernel MB's dx: the grid's output
            # gradient both paths then share
            _, same_dx, same_scale = plain_sdf_loss_and_grads(
                net, xs, xv, table_scale=True, mlp_bwd=kernel_dx_bwd(net, xs, xv),
                level_frac=frac)
            over_same = int(((g - same_dx[n]).abs() > 2.0 ** -11 * same_scale).sum())
            check(over_same == 0, f"{what} {n}: {over_same} entries beyond 2^-11·S against "
                  "the plain step on kernel MB's dx")
            hows.append(f"table {e / want[n].abs().max().item():.3e} of its max ({over} of "
                        f"{g.numel()} entries beyond 2^-11·S; {over_same} on kernel MB's dx)")
        elif n == "encoding.grid":
            e = compare_table_grad(g, want[n], scale, f"{what} {n}")
            ratio = ((g - want[n]).abs() / (2.0 ** -11 * scale + 1e-30)).max().item()
            hows.append(f"table {ratio:.3e} of its bound 2^-11·S")
        else:
            e = compare_rel(g, want[n], 1e-4, f"{what} {n}")
            hows.append(f"{n.split('.', 1)[1]} {e / want[n].abs().max().item():.3e}")
    print(f"{what}: loss {loss.item():.6f}, plain {want_loss.item():.6f}; gradients: "
          f"{', '.join(hows)} (weights 1e-4 of their max); launches {launches}")
    expect = expect or {"G": 2, "M": 2, "MB": 2, "GB": 1, "GI": 1, "GG": 1, "RS": 0, "GT": 0,
                        "MW": 0, "MBW": 0}
    check(launches == expect, f"{what}: launches {launches}, expected {expect}")
    return launches


def grid_kernel_checks(spec, table, x, dcols, ddx, frac=None, label="", shard=None):
    """G, GB, GI and GG against their plain versions: G at the grid bounds
    (bf16 tables with the fp32 sum's own error), GB per entry within
    2^-11·S, GI within 1e-5 of its largest magnitude, GG as
    ``check_second_order``.  ``shard`` (sid, n): ``table`` is rank sid's
    block-cyclic shard and every kernel runs in shard mode (G's partial
    features are fp32: the fp32 bound with the sum's own error).  Returns
    each kernel's max abs err (GG: the larger of its outputs')."""
    from tcnn_tpu_torch.ops.cuda.grid_encode import (
        grid_encode_bwd, grid_encode_bwd_input, grid_encode_bwd_input_plain,
        grid_encode_bwd_plain, grid_encode_fwd, grid_encode_plain)

    live = list(range(spec.n_levels))
    D, bf16 = spec.n_dims, table.dtype == torch.bfloat16
    sum_atol = ((1 << D) + 2 * D) * 2.0 ** -24
    err = {}
    with torch.inference_mode():
        e = 0.0
        for soa in (True, False):
            got = grid_encode_fwd(spec, table, x, live, soa=soa, level_frac=frac, shard=shard)
            torch.cuda.synchronize()
            want = grid_encode_plain(spec, table, x, live, soa=soa, level_frac=frac,
                                     shard=shard)
            if shard:
                e = max(e, compare_rel_sum(got, want, sum_atol, f"G {label}"))
            else:
                e = max(e, compare(got, want, "grid-bf16" if bf16 else "grid-f32",
                                   atol=sum_atol if bf16 else 0.0)[0])
        err["G"] = e
        got = grid_encode_bwd(spec, table, x, dcols, live, level_frac=frac, shard=shard)
        torch.cuda.synchronize()
        err["GB"] = compare_table_grad(
            got, grid_encode_bwd_plain(spec, table, x, dcols, live, level_frac=frac,
                                       shard=shard),
            grid_encode_bwd_plain(spec, table.float(), x, dcols.float().abs(), live,
                                  level_frac=frac, shard=shard), f"GB {label}")
        got = grid_encode_bwd_input(spec, table, x, dcols, live, level_frac=frac, shard=shard)
        torch.cuda.synchronize()
        err["GI"] = compare_rel(got, grid_encode_bwd_input_plain(spec, table, x, dcols, live,
                                                                 level_frac=frac, shard=shard),
                                1e-5, f"GI {label}")
    e_gg, e_flat = check_second_order(spec, table, x, dcols, ddx, live, frac, shard, label)
    err["GG"] = max(e_gg, e_flat)
    print(f"{label} table={str(table.dtype)[6:]}: max abs err G {err['G']:.3e}, GB "
          f"{err['GB']:.3e}, GI {err['GI']:.3e}, GG {e_gg:.3e} (d_dcols, d_x; bit for bit in "
          f"a second launch), its table gradient {e_flat:.3e} (2^-11·S over its updates' terms)")
    return err


def time_grid_kernels(spec, table, x, dcols, ddx, t, keys, frac=None, u_bytes=0, picks=None,
                      shard=None, plain_calls=10):
    """Device times of G, GB, GI and GG (those in ``keys``: timing key ->
    kernel) on these inputs, their plain versions' and their bounds into t.
    With ``shard`` the kernels run in shard mode on the shard ``table``:
    the bounds count its rows the batch touches, and the corner work of the
    corners it holds (this run's share).  ``plain_calls``: the plain
    versions' calls per timing."""
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.grid_encode import (
        grid_encode_bwd, grid_encode_bwd_bwd, grid_encode_bwd_bwd_plain, grid_encode_bwd_input,
        grid_encode_bwd_input_plain, grid_encode_bwd_plain, grid_encode_fwd, grid_encode_plain)

    live, B = list(range(spec.n_levels)), x.shape[0]
    kw = {"level_frac": frac, "shard": shard}
    calls = {
        "G": (lambda: grid_encode_fwd(spec, table, x, live, soa=True, **kw),
              lambda: grid_encode_plain(spec, table, x, live, soa=True, **kw)),
        "GB": (lambda: grid_encode_bwd(spec, table, x, dcols, live, **kw),
               lambda: grid_encode_bwd_plain(spec, table, x, dcols, live, **kw)),
        "GI": (lambda: grid_encode_bwd_input(spec, table, x, dcols, live, **kw),
               lambda: grid_encode_bwd_input_plain(spec, table, x, dcols, live, **kw)),
        "GG": (lambda: grid_encode_bwd_bwd(spec, table, x, dcols, ddx, live, **kw),
               lambda: grid_encode_bwd_bwd_plain(spec, table, x, dcols, ddx, live, **kw))}
    consts = spec.n_levels * grid_ops.LEVEL_FIELDS * 4
    touched = touched_bytes(spec, x, table.element_size(), shard)
    owned = 1.0
    if shard:   # the share of (sample, level, corner) whose row the shard holds
        idx, _ = grid_ops.build_indices_weights(spec, x, live, shard=shard)
        owned = float((idx >= 0).float().mean())
    keep = 1.0 if frac is None else float(
        (torch.arange(spec.n_levels, device=x.device)[:, None].float()
         < frac[None] * float(spec.n_levels) + 1e-3).float().mean())
    rng = rng_hash_ops(spec, x) if spec.hash_type.value == "Rng" else 0
    rng_ops = {k: rng for k in ("G", "GI", "GG")}
    rng_ops["GB"] = rng if picks is None else rng_hash_ops(spec, x, picks)
    pos = B * spec.n_levels * 4 * spec.n_dims   # positions and fractions, every corner's

    def ops(total):   # the corner work of the held corners
        return pos + owned * (total - pos)

    with torch.inference_mode():
        outs = {k: calls[k][0]() for k in keys.values()}
        b = {"G": (nbytes(x, outs.get("G", x[:0])) + touched + consts,
                   keep * (ops(grid_flops(spec, B)) + rng), PEAK_FP32),
             "GB": (nbytes(x, dcols, table) + consts + u_bytes,
                    keep * (ops(grid_flops(spec, B)) + rng_ops["GB"]), PEAK_FP32),
             "GI": (nbytes(x, dcols, outs.get("GI", x[:0])) + touched + consts,
                    keep * (ops(gi_flops(spec, B)) + rng), PEAK_FP32),
             "GG": (nbytes(x, ddx, dcols, *[o for o in outs.get("GG", ()) if o is not None])
                    + touched + consts, keep * (ops(gg_flops(spec, B)) + rng), PEAK_FP32)}
        for key, k in keys.items():
            t[key] = graph_ms(calls[k][0])
            t[key + " plain"] = eager_ms(calls[k][1], n=plain_calls)
            t[key + " bound"] = bound_ms(*b[k])
            t[key + " bound by"] = bound_by(*b[k])
            print(f"{key}: {t[key]:.4f} ms on the device (plain {t[key + ' plain']:.4f} ms, "
                  f"bound {t[key + ' bound']:.4f} ms: {b[k][0] / 1e6:.2f} MB, "
                  f"{b[k][1] / 1e9:.3f} G operations on the fp32 units"
                  f"{f', {rng_ops[k] / 1e9:.3f} G of them Rng hashing' if rng else ''})")


def entries(t, items, launches, errors, extra=None):
    """Report entries: items = [(timing key, kernel, replaces)]."""
    out = []
    for key, k, replaced in items:
        name, source = KERNELS[k]
        entry = {"name": f"{name} ({key.split(' ', 1)[1]})", "route": "cuda",
                 "source": source, "replaces": replaced, "launches": launches[k],
                 "max_abs_err": errors[key], "ms": t[key], "plain_ms": t[key + " plain"],
                 "bound_ms": t[key + " bound"], "bound_by": t[key + " bound by"],
                 "library_ms": t.get(key + " library")}
        entry.update(extra or {})
        out.append(entry)
    return out


def rng_stochastic_slice(gen, dev, hash_times):
    """config_hash with ``"hash": "Rng"`` and ``"stochastic_interpolation":
    true`` at BF16_POLICY and B = 2^18: G, GB, GI and GG (Rng) and GB
    (stochastic) against their plain versions, 200 steps of
    ``make_training_loop`` (a captured graph; the loss falls) and an input
    gradient's second order on the trained model, the main path; the times
    and the step's device time beside config_hash's."""
    import dataclasses
    import json
    import re

    from tcnn_tpu_torch import BF16_POLICY, create_from_config
    from tcnn_tpu_torch.common import HashType
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image
    from tcnn_tpu_torch.utils.metrics import psnr

    cfg = json.loads(re.sub(r"//[^\n]*", "", open(CONFIG).read()))
    cfg["encoding"] = {**cfg["encoding"], "hash": "Rng", "stochastic_interpolation": True}
    model = create_from_config(2, 3, cfg, policy=BF16_POLICY)
    enc = model.network.encoding
    spec = enc.spec
    check(spec.hash_type == HashType.RNG and spec.stochastic_interpolation,
          f"grid {spec.hash_type}, stochastic {spec.stochastic_interpolation}")
    det = dataclasses.replace(spec, stochastic_interpolation=False)
    with torch.no_grad():
        enc.grid.uniform_(-1, 1, generator=gen)
    B, live = MAIN_BATCH, list(range(spec.n_levels))
    print(f"config_hash with Rng and stochastic interpolation: {spec.n_entries} rows, "
          f"{sum(lv.use_hash for lv in spec.levels)} hashed levels")

    phase(f"slice 11: G, GB, GI and GG (Rng) and GB (stochastic) vs plain, B={B}")
    x = torch.rand((B, 2), generator=gen, device=dev)
    ddx = torch.randn((B, 2), generator=gen, device=dev)
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        table = enc.grid.detach().to(dtype)
        dcols = torch.randn((spec.n_output_dims, B), generator=gen, device=dev).to(dtype)
        e = grid_kernel_checks(det, table, x, dcols, ddx, label="Rng")
        e_st = grid_kernel_checks(spec, table, x, dcols, ddx, label="Rng, stochastic")["GB"]
        if dtype == torch.bfloat16:
            err.update({f"{k} Rng": v for k, v in e.items()})
            err["GB Rng, stochastic"] = e_st
    # each (sample, level) puts its whole cotangent on one corner: a level's
    # gradient sums to the sum of its cotangents (fp32, the sums' own error)
    dcols = torch.randn((spec.n_output_dims, B), generator=gen, device=dev)
    with torch.inference_mode():
        g = grid_encode_bwd(spec, enc.grid.detach(), x, dcols, live).reshape(-1, 2)
        for l, lv in enumerate(spec.levels):
            got = g[lv.offset:lv.offset + lv.size].double().sum(0)
            want = dcols[2 * l:2 * l + 2].double().sum(1)
            check(bool(((got - want).abs() <= 1e-5 * dcols[2 * l:2 * l + 2].abs().sum(1)).all()),
                  f"stochastic GB: level {l} sums {got.tolist()}, cotangents {want.tolist()}")
    print("stochastic GB: every level's gradient sums to its cotangents' sum")

    phase(f"slice 11: {RNG_STEPS} steps of make_training_loop at B={B} (Rng, stochastic), "
          "CUDA graph replay, then an input gradient's second order: the main path")
    image = synthetic_image(1024, 1024)
    sampler = ImageSampler(image, seed=0)
    torch.cuda.synchronize()
    reset_counts()
    loop = model.trainer.make_training_loop(lambda i: sampler.sample_batch(B), RNG_STEPS)
    losses = loop()
    torch.cuda.synchronize()
    xg = torch.rand((B, 2), generator=gen, device=dev).requires_grad_()
    (gx,) = torch.autograd.grad(model.network(xg).float().square().sum(), xg, create_graph=True)
    second = torch.autograd.grad(gx.square().sum(), list(model.network.parameters()))
    torch.cuda.synchronize()
    launches = counts()
    # the loop's warm-up and captured steps (G, M, GB and MB twice), then the
    # forward (G and M), the input gradient (MB, GI) and its backward (GG;
    # the features' second pass: MB and GB, and no GI: the parameters' pass
    # uses no gradient in x)
    check(launches["G"] == launches["M"] == 3 and launches["GB"] >= 2 and launches["MB"] >= 3
          and launches["GI"] >= 1 and launches["GG"] == 1 and launches["RS"] == 0,
          f"launches {launches}")
    check(all(bool(torch.isfinite(s).all()) for s in second), "non-finite second order")
    losses = losses.cpu()
    check(bool(torch.isfinite(losses).all()), "non-finite training loss")
    first, last10 = float(losses[0]), float(losses[-10:].mean())
    fit_psnr = psnr(model.trainer.inference(sampler.full_grid_coords()),
                    sampler.image.reshape(-1, 3))
    print(f"loss {first:.4f} -> {last10:.4f} (mean of the last 10, {last10 / first:.4f}x); "
          f"PSNR {fit_psnr:.2f} dB; launches {launches}")
    check(last10 < 0.2 * first, f"loss floor missed: {last10} >= 0.2 x {first}")
    check(fit_psnr > 20.0, f"PSNR floor missed: {fit_psnr:.2f} dB")

    phase(f"slice 11 times at B={B} (bf16 table): G, GI, GG (Rng), GB (stochastic), step")
    t = {}
    table = enc.grid.detach().to(torch.bfloat16)
    dcols = torch.randn((spec.n_output_dims, B), generator=gen, device=dev).to(torch.bfloat16)
    _, ws = grid_ops.build_indices_weights(spec, x, live, scatter=True)
    picks = ws.reshape(spec.n_levels, 4, B).argmax(dim=1)
    time_grid_kernels(det, table, x, dcols, ddx, t,
                      {"G Rng": "G", "GI Rng": "GI", "GG Rng": "GG"})
    time_grid_kernels(spec, table, x, dcols, ddx, t, {"GB Rng, stochastic": "GB"},
                      u_bytes=spec.n_levels * B * 4, picks=picks)
    # the step as the loop replays it (its captured graph): CUDA events
    # around RNG_STEPS replays
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loop()
    end.record()
    end.synchronize()
    t["step device"] = start.elapsed_time(end) / RNG_STEPS
    print(f"training step at B={B}: {t['step device']:.4f} ms per replayed step with the Rng "
          f"hash and stochastic interpolation; config_hash's {hash_times['loop step']:.4f} ms "
          f"per replayed step ({hash_times['step device']:.4f} ms of device work) in this run")
    items = [("G Rng", "G", REPLACES_G), ("GB Rng, stochastic", "GB", REPLACES_GB),
             ("GI Rng", "GI", REPLACES_GI), ("GG Rng", "GG", REPLACES_GG)]
    return entries(t, items, launches, err, {"step_ms": t["step device"],
                                             "config_hash_step_ms": hash_times["loop step"]})


def masked_sdf_slice(gen, dev):
    """The SDF sample's grid and MLP at B = 2^18 with per-sample level
    fractions: GG under the mask against its plain version (fractions 0.5
    and spread over [0, 1]), the masked eikonal step (the main path)
    against the same step through the plain versions, GG's times."""
    from tcnn_tpu_torch import Policy, create_from_config
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf

    model = create_from_config(3, 1, sdf.CONFIG, policy=Policy())
    net = model.network
    spec = net.encoding.spec
    with torch.no_grad():
        net.encoding.grid.uniform_(-1, 1, generator=gen)
    B = MAIN_BATCH
    phase(f"slice 11: GG (and G, GB, GI) under a per-sample level mask, SDF geometry, B={B}")
    x = torch.rand((B, 3), generator=gen, device=dev) * 0.9 + 0.05
    ddx = torch.randn((B, 3), generator=gen, device=dev)
    half = torch.full((B,), 0.5, device=dev)
    spread = torch.rand(B, generator=gen, device=dev)
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        table = net.encoding.grid.detach().to(dtype)
        dcols = torch.randn((spec.n_output_dims, B), generator=gen, device=dev).to(dtype)
        for frac, what in ((half, "fraction 0.5"), (spread, "fractions in [0, 1]")):
            e = grid_kernel_checks(spec, table, x, dcols, ddx, frac, f"masked, {what}")
            if dtype == torch.float32 and frac is half:
                err["GG masked"] = e["GG"]

    phase(f"slice 11: the eikonal step at B={B} with a per-sample fraction of 0.5")
    xs, xv = sdf.sample_points(gen, B, dev)
    launches = check_eikonal_step(net, xs, xv, half, "masked eikonal step")
    t = {}
    table = net.encoding.grid.detach()
    dcols = torch.randn((spec.n_output_dims, B), generator=gen, device=dev)
    time_grid_kernels(spec, table, xv, dcols, ddx, t, {"GG masked": "GG"}, frac=half)
    return entries(t, [("GG masked", "GG", REPLACES_GG)], launches, err)


def torch_func_slice(gen, dev):
    """torch.func.jvp and jacrev of the config_hash network (fp32 policy) at
    B = 2^18 through the kernels against the same transforms of the plain
    versions (torch operations), and the reverse-mode launches after them."""
    from tcnn_tpu_torch import DEFAULT_POLICY, create_from_config

    model = create_from_config(2, 3, CONFIG, policy=DEFAULT_POLICY)
    net = model.network
    with torch.no_grad():
        net.encoding.grid.uniform_(-1, 1, generator=gen)
    names = [n for n, _ in net.named_parameters()]
    params = {n: p.detach() for n, p in net.named_parameters()}
    B = MAIN_BATCH
    phase(f"slice 11: torch.func.jvp of the config_hash network at B={B}, in x and in "
          f"every parameter at once, against the plain versions")
    x = torch.rand((B, 2), generator=gen, device=dev)
    tx = torch.randn((B, 2), generator=gen, device=dev)
    tp = {n: torch.randn(p.shape, generator=gen, device=dev) for n, p in params.items()}
    torch.cuda.synchronize()
    reset_counts()
    y, t = torch.func.jvp(lambda p, v: torch.func.functional_call(net, p, (v,)),
                          (params, x), (tp, tx))
    torch.cuda.synchronize()
    jvp_launches = counts()
    check(jvp_launches == {"G": 2, "M": 1, "GB": 0, "MB": 0, "GI": 0, "GG": 1, "RS": 0,
                           "GT": 0, "MW": 0, "MBW": 0},
          f"jvp launches {jvp_launches}: expected G for the primal and the table tangent, "
          f"GG for the input tangent, M, and no backward kernel")
    y_p, t_p = torch.func.jvp(lambda p, v: plain_net(net, p, v), (params, x), (tp, tx))
    e_y = compare(y, y_p, "mlp-f32")[0]
    e_t = compare_rel(t, t_p, 1e-4, "jvp tangent")
    print(f"jvp: output max abs err {e_y:.3e} (rtol 1e-5, atol 1e-5), tangent {e_t:.3e} "
          f"(1e-4 of its max); launches {jvp_launches}")

    phase(f"slice 11: torch.func.jacrev of the first {JACREV_ROWS} rows' outputs at B={B}, "
          "in x and in the table")
    reset_counts()
    jx = torch.func.jacrev(lambda v: torch.func.functional_call(net, params, (v,))[:JACREV_ROWS])(x)
    jt = torch.func.jacrev(lambda g: torch.func.functional_call(
        net, {**params, "encoding.grid": g}, (x,))[:JACREV_ROWS])(params["encoding.grid"])
    torch.cuda.synchronize()
    jac_launches = counts()
    jx_p = torch.func.jacrev(lambda v: plain_net(net, params, v)[:JACREV_ROWS])(x)
    jt_p = torch.func.jacrev(lambda g: plain_net(net, {**params, "encoding.grid": g},
                                                 x)[:JACREV_ROWS])(params["encoding.grid"])
    e_x = compare_rel(jx, jx_p, 1e-4, "jacrev in x")
    e_g = compare_rel(jt, jt_p, 1e-4, "jacrev in the table")
    print(f"jacrev {tuple(jx.shape)} in x: max abs err {e_x:.3e}; {tuple(jt.shape)} in the "
          f"table: {e_g:.3e} (1e-4 of each max); launches {jac_launches}")

    phase("slice 11: reverse mode after torch.func: one training step's launches")
    target = torch.rand((B, 3), generator=gen, device=dev)
    reset_counts()
    loss = model.trainer.training_step(x, target)
    torch.cuda.synchronize()
    check(first_order_counts() == {"G": 1, "M": 1, "GB": 1, "MB": 1},
          f"training step launches {counts()}, expected one of each kernel")
    check(bool(torch.isfinite(loss)), "training step loss is not finite")
    print(f"training_step: loss {loss.item():.6f}; launches {counts()}")


def wide_grid_slice(gen, dev):
    """5- and 7-D hash grids: G, GB, GI and GG (each kernel's one
    run-time-D instance) against their plain versions, a second-order
    eikonal step of a 7-D NetworkWithInputEncoding against the plain
    versions on each of ``WIDE_EIKONAL_DRAWS`` draws of weights and points
    (the main path; the report takes the first draw's launches), and the
    7-D kernels' times."""
    from tcnn_tpu_torch import Policy, create_network_with_input_encoding
    from tcnn_tpu_torch.common import HashType
    from tcnn_tpu_torch.ops import grid_ops

    err, t, timed = {}, {}, None
    for D in (5, 7):
        B = WIDE_BATCH[D]
        phase(f"slice 11: a {D}-D hash grid, G, GB, GI and GG vs plain at B={B}")
        for hash_type in (HashType.COHERENT_PRIME, HashType.RNG):
            spec = grid_ops.make_grid_spec(D, 4, 2, 15, 4, 1.5, hash_type=hash_type,
                                           interpolation=grid_ops.InterpolationType.SMOOTHSTEP)
            x = torch.rand((B, D), generator=gen, device=dev) * 0.9 + 0.05
            ddx = torch.randn((B, D), generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                table = (torch.rand(spec.n_params, generator=gen, device=dev) * 2 - 1).to(dtype)
                dcols = torch.randn((spec.n_output_dims, B), generator=gen, device=dev).to(dtype)
                label = f"{D}-D {hash_type.value}"
                e = grid_kernel_checks(spec, table, x, dcols, ddx, label=label)
                e2 = grid_kernel_checks(spec, table, x, dcols, ddx,
                                        torch.rand(B, generator=gen, device=dev),
                                        label + " masked")
                if D == 7 and hash_type == HashType.COHERENT_PRIME and dtype == torch.float32:
                    err.update({f"{k} 7-D": max(e[k], e2[k]) for k in ("G", "GB", "GI", "GG")})
                    timed = (spec, table, x, dcols, ddx)
    phase(f"slice 11: the 7-D kernels' times at B={WIDE_BATCH[7]} (fp32 table, CoherentPrime)")
    time_grid_kernels(*timed, t, {"G 7-D": "G", "GB 7-D": "GB", "GI 7-D": "GI", "GG 7-D": "GG"})
    B = WIDE_BATCH[7]
    phase(f"slice 11: the eikonal step of a 7-D NetworkWithInputEncoding at B={B}, "
          f"{WIDE_EIKONAL_DRAWS} draws of weights and points")
    runs = []
    for seed in range(WIDE_EIKONAL_DRAWS):   # at 2^13 a ReLU switches in about one draw of ten
        net = create_network_with_input_encoding(
            7, 1, {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                   "log2_hashmap_size": 15, "base_resolution": 4, "per_level_scale": 1.5,
                   "interpolation": "Smoothstep"},
            {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2,
             "activation": "ReLU", "output_activation": "None"}, policy=Policy(),
            generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            net.encoding.grid.uniform_(-1, 1, generator=gen)
        xs = torch.rand((B, 7), generator=gen, device=dev) * 0.9 + 0.05
        xv = torch.rand((B, 7), generator=gen, device=dev) * 0.9 + 0.05
        runs.append(check_eikonal_step(net, xs, xv, None, f"7-D eikonal step, draw {seed}"))
    items = [(f"{k} 7-D", k, r) for k, r in (("G", REPLACES_G), ("GB", REPLACES_GB),
                                             ("GI", REPLACES_GI), ("GG", REPLACES_GG))]
    return entries(t, items, runs[0], err)


def deep_mlp_slice(gen, dev):
    """Kernel MB at width 128 with 12 hidden layers (two launches, kernel M
    at their boundary), bf16 and fp32, against the plain version at
    B = 2^18: fp32 every dW and dx within 1e-4 of its largest magnitude;
    bf16 every dW within 2e-2 of its largest magnitude and dx within 2e-2 in
    relative L2 norm (a hidden value that rounds to the other bf16
    neighbour, or a ReLU it switches, moves a whole dx row, and over twelve
    layers such rows are more than ``relu_flip_rows`` explains; the per-row
    bound holds at six layers, config_oneblob).  Then three training steps
    of config_hash with that MLP, the main path, and the times."""
    import json
    import re

    from tcnn_tpu_torch import BF16_POLICY, DEFAULT_POLICY, create_from_config
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd, fused_mlp_bwd_plain

    B, dims = MAIN_BATCH, mlp_dims(32, 128, DEEP_HIDDEN)
    relu, none = Activation.RELU, Activation.NONE
    err, t = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        key = f"MB 128 x {DEEP_HIDDEN}, {str(dtype)[6:]}"
        phase(f"slice 11: {key} vs plain at B={B}")
        ws = random_mlp(gen, dev, dims)
        x = (torch.rand((B, 32), generator=gen, device=dev) * 2 - 1).to(dtype)
        g = torch.randn((B, 3), generator=gen, device=dev)
        with torch.inference_mode():
            before = fused_mlp_bwd.launches
            got_dws, got_dx = fused_mlp_bwd(ws, x, g, relu, none, dtype)
            torch.cuda.synchronize()
            n_launches = fused_mlp_bwd.launches - before
            want_dws, want_dx = fused_mlp_bwd_plain(ws, x, g, relu, none, dtype)
        check(n_launches == 2, f"{key}: {n_launches} launches of MB, expected 2")
        if dtype == torch.float32:
            e = compare_mlp_grads([*got_dws, got_dx], [*want_dws, want_dx], dtype, key)
            how = "every dW and dx within 1e-4 of its max"
        else:
            e = compare_mlp_grads(got_dws, want_dws, dtype, key)
            rel = ((got_dx.float() - want_dx.float()).norm() / want_dx.float().norm()).item()
            check(rel <= 2e-2, f"{key}: dx relative L2 error {rel:.3e} beyond 2e-2")
            how = f"dW within 2e-2 of each max; dx relative L2 error {rel:.3e} (2e-2)"
        err[key] = e
        print(f"{key}: max abs err {e:.3e} ({how}); {n_launches} launches of MB")
        hs = chain_activations([w.to(dtype) for w in ws], x)
        with torch.inference_mode():
            t[key] = graph_ms(lambda: fused_mlp_bwd(ws, x, g, relu, none, dtype))
            t[key + " plain"] = eager_ms(lambda: fused_mlp_bwd_plain(ws, x, g, relu, none,
                                                                     dtype))
            t[key + " library"] = graph_ms(lambda: library_bwd([w.to(dtype) for w in ws],
                                                               hs, g))
        m_flops = 2 * B * sum(w.numel() for w in ws)
        n_bytes = nbytes(x, g, *[w.to(dtype) for w in ws], x) + sum(w.numel() for w in ws) * 4
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
        t[key + " bound"] = bound_ms(n_bytes, 3 * m_flops, peak)
        t[key + " bound by"] = bound_by(n_bytes, 3 * m_flops, peak)
        print(f"{key}: {t[key]:.4f} ms on the device with the boundary's kernel M (plain "
              f"{t[key + ' plain']:.4f} ms, cuBLAS chain backward {t[key + ' library']:.4f} "
              f"ms, bound {t[key + ' bound']:.4f} ms: {n_bytes / 1e6:.2f} MB, "
              f"{3 * m_flops / 1e9:.3f} GFLOP on the {UNIT[peak]})")
    phase(f"slice 11: three training steps of config_hash with a FullyFusedMLP 128 x "
          f"{DEEP_HIDDEN} at B={B}, both policies: the main path")
    cfg = json.loads(re.sub(r"//[^\n]*", "", open(CONFIG).read()))
    cfg["network"] = {**cfg["network"], "n_neurons": 128, "n_hidden_layers": DEEP_HIDDEN}
    xb = torch.rand((B, 2), generator=gen, device=dev)
    target = torch.rand((B, 3), generator=gen, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    for policy in (DEFAULT_POLICY, BF16_POLICY):
        model = create_from_config(2, 3, cfg, policy=policy)
        step_losses = [float(model.trainer.training_step(xb, target)) for _ in range(3)]
        check(all(np.isfinite(step_losses)), f"deep MLP losses {step_losses}")
    torch.cuda.synchronize()
    launches = first_order_counts()
    check(launches == {"G": 6, "M": 12, "GB": 6, "MB": 12},
          f"deep MLP launches {launches}: expected per step G and GB once, M and MB twice")
    print(f"six steps (three per policy): launches {launches}, last losses {step_losses}")
    items = [(k, "MB", REPLACES_MB) for k in err]
    return entries(t, items, {"MB": launches["MB"]}, err)


PARALLEL_STEPS = 20        # HybridParallel (config_btf) and DataParallel (config_hash) steps
PARALLEL_SDF_STEPS = 5     # the eikonal steps through sharded tables
# Two ranks against one process: the first step's loss within 1e-5 relative
# (the same parameters; the ranks' mean of means is the global mean up to
# fp32 rounding), every later step's within 1e-2 (a gradient that rounds
# another way moves Adam's step by ±lr where it lies near 0, so the runs
# drift apart: on the CPU, 20 DataParallel steps of config_hash at 2^14 differed
# by up to 2.5e-3, tools/parallel_check.py), and the trained models'
# predictions within the whole model's bf16 rtol, 2e-2, as a relative L2 norm.
PARALLEL_FIRST_RTOL = 1e-5
PARALLEL_LOSS_RTOL = 1e-2
PARALLEL_PRED_REL = 2e-2
# The first step's reduced gradients (the optimizer's input, each table
# gathered) against one process's, per parameter as a relative L2 norm.
# Adam's update barely moves when a gradient is scaled, so the losses
# cannot show a missing ÷n_model or ÷world: that puts a gradient at a
# distance of 1 (n = 2).  The limit leaves room for bf16 gradients summed
# in another order (one bf16 ulp is 2^-8 of an entry).
PARALLEL_GRAD_REL = 1e-2


def parallel_slice(gen, dev):
    """Slice 12, parallelism.  (a) In this process: config_btf's grid
    (4-D CoherentAdd, 16 levels, 2^19-row tables) row-sharded 2 ways, B =
    2^18 (the gathered batch), fp32 and bf16 tables: each shard's G, GB, GI
    and GG in shard mode against their plain versions; the shards' G and GI
    partials summed against the unsharded kernel; the shards' GB gradients
    against the block-cyclic slices of the unsharded GB's; the unsharded
    kernels on the whole table, GG's table gradient under the same bound;
    G's and GB's shard-mode times (bf16, shard 0) beside their bounds.  The
    SDF sample's grid (3-D Smoothstep, fp32), where the main path runs GI
    and GG in shard mode, at the eikonal job's gathered batch 2^14: each
    shard's kernels against their plain versions, and GI's and GG's
    shard-mode times beside their bounds.  (b) Two gloo ranks
    on this one card (``tools/parallel_check.py``; NCCL refuses two ranks on
    one device), the main path: ``HybridParallel`` at n_model 2 training
    config_btf's full model (BF16_POLICY, global batch 2^18, 20 steps),
    ``DataParallel`` training config_hash (BF16_POLICY, 2^18, 20 steps), and
    the SDF sample's eikonal loss under ``HybridParallel`` (2^14, 5 steps,
    GI and GG in shard mode).  Each against the same training in one
    process: the ranks' losses within ``PARALLEL_FIRST_RTOL`` of its first
    loss and ``PARALLEL_LOSS_RTOL`` of every later one, and a model holding the ranks' gathered parameters
    (``gather_state``) predicting within ``PARALLEL_PRED_REL`` (relative L2)
    of its model on 2^16 held-out inputs; ``gather_state`` of the freshly
    sharded table gives it back bit for bit; the first step's reduced
    gradients within ``PARALLEL_GRAD_REL`` of one process's.  The ranks' step and
    collective times are one card shared by two processes: no scaling."""
    import tempfile

    from tcnn_tpu_torch.common import HashType
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_bwd, grid_encode_bwd_input,
                                                     grid_encode_bwd_plain, grid_encode_fwd)
    from tcnn_tpu_torch.tools import parallel_check

    n = 2
    spec = grid_ops.make_grid_spec(4, 16, 2, 19, 16, 1.5, hash_type=HashType.COHERENT_ADD)
    check(spec.n_params == BTF_GRID_PARAMS and grid_ops.shardable_levels(spec, n),
          "config_btf's grid")
    live = list(range(spec.n_levels))
    sum_atol = ((1 << spec.n_dims) + 2 * spec.n_dims) * 2.0 ** -24
    phase(f"slice 12: config_btf's grid row-sharded {n} ways, G, GB, GI and GG of each "
          f"shard vs plain at B={MAIN_BATCH}")
    x = torch.rand((MAIN_BATCH, 4), generator=gen, device=dev)
    # the gathered output gradient of fp32 partial features is fp32
    dcols = torch.randn((spec.n_output_dims, MAIN_BATCH), generator=gen, device=dev)
    ddx = torch.randn((MAIN_BATCH, 4), generator=gen, device=dev)
    perm = torch.from_numpy(grid_ops.block_cyclic_perm(spec, n)).to(dev)
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        table = (torch.rand(spec.n_params, generator=gen, device=dev) * 2 - 1).to(dtype)
        shards = [b.clone() for b in table[perm].chunk(n)]   # fresh, aligned
        for sid in range(n):
            e = grid_kernel_checks(spec, shards[sid], x, dcols, ddx,
                                   label=f"config_btf shard {sid} of {n}", shard=(sid, n))
            for k in ("G", "GB", "GI", "GG"):
                err[f"{k} shard"] = max(err.get(f"{k} shard", 0.0), e[k])
        with torch.inference_mode():
            total = sum(grid_encode_fwd(spec, b, x, live, soa=True, shard=(i, n))
                        for i, b in enumerate(shards))
            whole = grid_encode_fwd(spec, table, x, live, soa=True)
            if dtype == torch.bfloat16:   # the sum rounded once, as the whole kernel's
                e_sum = compare(total.to(dtype), whole, "grid-bf16", atol=n * sum_atol)[0]
            else:
                e_sum = compare_rel_sum(total, whole, n * sum_atol, "G partials' sum")
            dx = sum(grid_encode_bwd_input(spec, b, x, dcols, live, shard=(i, n))
                     for i, b in enumerate(shards))
            e_dx = compare_rel(dx, grid_encode_bwd_input(spec, table, x, dcols, live), 1e-5,
                               "GI partials' sum")
            grads = torch.cat([grid_encode_bwd(spec, b, x, dcols, live, shard=(i, n))
                               for i, b in enumerate(shards)])
            whole_g = grid_encode_bwd(spec, table, x, dcols, live)
            scale = grid_encode_bwd_plain(spec, table.float(), x, dcols.abs(), live)
            e_gb = compare_table_grad(grads, whole_g[perm], scale[perm],
                                      "GB shards vs the block-cyclic slices of GB")
            torch.cuda.synchronize()
        print(f"table={str(dtype)[6:]}: the shards' G partials summed vs G: max abs err "
              f"{e_sum:.3e}; GI partials summed vs GI {e_dx:.3e}; the shards' GB vs the "
              f"unsharded GB's block-cyclic slices {e_gb:.3e}")
        # the same kernels unsharded on the whole table, GG's table gradient
        # under the same sound bound as in shard mode
        grid_kernel_checks(spec, table, x, dcols, ddx, label="config_btf unsharded")
    phase(f"slice 12: shard-mode kernel times at config_btf (bf16 table, shard 0 of {n}, "
          f"B={MAIN_BATCH}), device time in a CUDA graph")
    t = {}
    time_grid_kernels(spec, shards[0], x, dcols, ddx, t, {"G shard": "G", "GB shard": "GB"},
                      shard=(0, n), plain_calls=2)
    # GG there too, off the main path (config_btf trains first order): its
    # largest shard-mode shape
    time_grid_kernels(spec, shards[0], x, dcols, ddx, t, {"GG shard config_btf": "GG"},
                      shard=(0, n), plain_calls=1)

    # GI and GG run in shard mode on the main path only in the eikonal job:
    # the SDF sample's grid (3-D Smoothstep, fp32) at its gathered batch
    from tcnn_tpu_torch import Policy, create_from_config
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf

    sdf_spec = create_from_config(3, 1, sdf.CONFIG, policy=Policy()).network.encoding.spec
    check(grid_ops.shardable_levels(sdf_spec, n), "the SDF grid's levels do not shard")
    B = 1 << 14
    phase(f"slice 12: the SDF sample's grid row-sharded {n} ways, G, GB, GI and GG of each "
          f"shard vs plain at B={B} (the eikonal job's gathered batch), f32 table")
    _, xv = sdf.sample_points(gen, B, dev)
    dcols = torch.randn((sdf_spec.n_output_dims, B), generator=gen, device=dev)
    ddx = torch.randn((B, 3), generator=gen, device=dev)
    perm = torch.from_numpy(grid_ops.block_cyclic_perm(sdf_spec, n)).to(dev)
    table = torch.rand(sdf_spec.n_params, generator=gen, device=dev) * 2 - 1
    shards = [b.clone() for b in table[perm].chunk(n)]
    err["GI shard"] = err["GG shard"] = 0.0   # their rows report this shape
    for sid in range(n):
        e = grid_kernel_checks(sdf_spec, shards[sid], xv, dcols, ddx,
                               label=f"SDF shard {sid} of {n}", shard=(sid, n))
        for k in ("GI", "GG"):
            err[f"{k} shard"] = max(err[f"{k} shard"], e[k])
    phase(f"slice 12: shard-mode GI and GG times at the SDF grid (f32 table, shard 0 of {n}, "
          f"B={B}), device time in a CUDA graph")
    time_grid_kernels(sdf_spec, shards[0], xv, dcols, ddx, t,
                      {"GI shard": "GI", "GG shard": "GG"}, shard=(0, n))

    launches = {}
    for job, batch, steps, what in (
            ("hybrid_btf", MAIN_BATCH, PARALLEL_STEPS,
             "HybridParallel (n_model 2) training config_btf"),
            ("dp_hash", MAIN_BATCH, PARALLEL_STEPS, "DataParallel training config_hash"),
            ("eikonal_sdf", 1 << 14, PARALLEL_SDF_STEPS,
             "the SDF sample's eikonal loss under HybridParallel (n_model 2)")):
        phase(f"slice 12: two gloo ranks on this card: {what}, global batch {batch}, "
              f"{steps} steps, against one process")
        with tempfile.TemporaryDirectory() as tmp:
            outs, ref = parallel_check.compare(job, 2, steps, batch, dev, f"{tmp}/params.pt")
        got, want = np.asarray(outs[0]["losses"]), np.asarray(ref["losses"])
        check(all(o["losses"] == outs[0]["losses"] for o in outs), f"{job}: ranks' losses differ")
        check(bool(np.isfinite(got).all()), f"{job}: non-finite loss")
        rtol = np.full(steps, PARALLEL_LOSS_RTOL)
        rtol[0] = PARALLEL_FIRST_RTOL
        bad = np.abs(got - want) > rtol * np.abs(want)
        check(not bad.any(), f"{job}: losses {got.tolist()} vs one process {want.tolist()}")
        check(ref["pred_rel"] <= PARALLEL_PRED_REL,
              f"{job}: predictions {ref['pred_rel']:.3e} from one process's")
        check(job == "dp_hash" or all(o["round_trip"] for o in outs),
              f"{job}: gather_state of the sharded table is not the table")
        worst = max(ref["grad_rel"], key=ref["grad_rel"].get)
        check(ref["grad_rel"][worst] <= PARALLEL_GRAD_REL,
              f"{job}: first reduced gradients {ref['grad_rel']} from one process's")
        if dev.type == "cuda":   # slices 18 and 22: nothing captured over gloo on the card
            for entry in ("loop", "step", "inference"):
                got_r = [o["refusals"][entry] for o in outs]
                check(all("gloo" in (r or "") and "cannot be captured" in r for r in got_r),
                      f"{job}: the compiled {entry} over gloo on the card did not refuse: "
                      f"{got_r}")
        lc = outs[0]["launches"]
        want_k = (("G", "GB", "M", "MB") if job != "eikonal_sdf"
                  else ("G", "GB", "GI", "GG", "M", "MB"))
        check(all(lc[k] >= steps for k in want_k) and lc["RS"] == 0, f"{job}: launches {lc}")
        step_ms = [float(np.median(o["step_ms"][1:])) for o in outs]
        coll_ms = [float(np.median(o["collective_ms"][1:])) for o in outs]
        launches[job] = lc
        print(f"{job}: losses {got[0]:.6f} -> {got[-1]:.6f} (one process {want[0]:.6f} -> "
              f"{want[-1]:.6f}, max rel diff {float(np.max(np.abs(got - want) / np.abs(want))):.3e}); "
              f"predictions rel L2 {ref['pred_rel']:.3e} (two single-process runs "
              f"{ref['repeat_pred_rel']:.3e}); table rel L2 {ref['table_rel']:.3e} (two "
              f"single-process runs {ref['repeat_table_rel']:.3e}); shard of "
              f"{outs[0]['shard_numel']} table parameters; first reduced gradients rel L2 "
              f"at most {ref['grad_rel'][worst]:.3e} ({worst})")
        print(f"{job}: the compiled entry points over gloo on the card refused: "
              f"{outs[0]['refusals']!r}")
        print(f"{job}: per rank, median over steps 2-{steps}: step {step_ms} ms, of it in "
              f"collectives {coll_ms} ms (host clock, synchronised; one card shared by two "
              f"processes, gloo: no scaling figure); launches over {steps} steps {lc}")
    items = [("G shard", "G", REPLACES_G), ("GB shard", "GB", REPLACES_GB),
             ("GI shard", "GI", REPLACES_GI), ("GG shard", "GG", REPLACES_GG)]
    path_launches = {"G": launches["hybrid_btf"]["G"], "GB": launches["hybrid_btf"]["GB"],
                     "GI": launches["eikonal_sdf"]["GI"], "GG": launches["eikonal_sdf"]["GG"]}
    return entries(t, items, path_launches, err, {"n_shards": n})


NCCL_LOOP_STEPS = 50      # slice 18: the one-rank NCCL loop's steps per call
NCCL_LOOP_ROUNDS = 3      # timed calls of each loop, in turns


def parallel_loop_slice(dev, hash_entries):
    """Slice 18, the parallel training loop, on the one card (NCCL refuses
    two ranks on one device).  (a) In a spawned process with a one-rank
    NCCL group (``file://`` rendezvous in a temporary directory):
    ``DataParallel.make_training_loop`` trains config_hash (BF16_POLICY, B =
    2^18, ``NCCL_LOOP_STEPS`` steps from the seeded image sampler), the main
    path, against ``Trainer.make_training_loop`` on the same batches in the
    same process: the first loss within ``PARALLEL_FIRST_RTOL``, every later
    one within ``PARALLEL_LOSS_RTOL`` (GB's atomics rule out equal bits);
    G, GB, M and MB once each in the warm-up step and once each in the
    captured step, which every replay launches; both loops' ms per step
    (host clock) and device ms per replayed step, so the idle share, and
    the same steps' eager ms through ``make_training_step``.  At one
    rank the step calls no collective (the port's wrappers skip a one-rank
    group), so (b) in the same group captures each collective the steps use
    (``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``)
    in a CUDA graph, in ``collectives.CAPTURE_MODE``, and holds its replays
    against eager calls, bit for bit.  (c), two gloo ranks on the card
    refusing the loop, runs in ``parallel_slice``.  Returns the main path's
    kernel entries: launches from this phase, the kernels' times, bounds and
    errors from config_hash's phase of this run (the same shapes)."""
    import tempfile

    from tcnn_tpu_torch.tools import parallel_check

    phase(f"slice 18: DataParallel.make_training_loop on a one-rank NCCL group, config_hash at "
          f"B={MAIN_BATCH}, {NCCL_LOOP_STEPS} steps, against Trainer.make_training_loop")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        res, = parallel_check.run_ranks(1, parallel_check.nccl_loop_job,
                                        {"steps": NCCL_LOOP_STEPS, "batch": MAIN_BATCH,
                                         "rounds": NCCL_LOOP_ROUNDS},
                                        timeout=600, tmp=tmp, backend="nccl")
    check(res["backend"] == "nccl", f"the group's backend is {res['backend']}")
    got = np.asarray(res["losses"]["parallel"])
    want = np.asarray(res["losses"]["trainer"])
    check(bool(np.isfinite(got).all()), "the parallel loop: non-finite loss")
    rtol = np.full(NCCL_LOOP_STEPS, PARALLEL_LOSS_RTOL)
    rtol[0] = PARALLEL_FIRST_RTOL
    check(not (np.abs(got - want) > rtol * np.abs(want)).any(),
          f"the parallel loop's losses {got.tolist()} vs the trainer's {want.tolist()}")
    check(got[-1] < got[0], f"the parallel loop did not train: {got[0]} -> {got[-1]}")
    for what in ("parallel", "trainer"):
        for when in ("warm_up", "per_replay"):
            c = res[when][what]
            check({k: c[k] for k in FIRST_ORDER} == {"G": 1, "M": 1, "GB": 1, "MB": 1}
                  and all(c[k] == 0 for k in c if k not in FIRST_ORDER),
                  f"{what} loop, {when}: launches {c}, expected G, M, GB and MB once")
    ms = {w: float(np.median(v)) for w, v in res["ms"].items()}
    dev_ms = {w: float(np.median(v)) for w, v in res["device_ms"].items()}
    print(f"losses {got[0]:.6f} -> {got[-1]:.6f} (Trainer.make_training_loop {want[0]:.6f} -> "
          f"{want[-1]:.6f}, max rel diff {float(np.max(np.abs(got - want) / np.abs(want))):.3e})")
    for w, label in (("parallel", "DataParallel.make_training_loop (one NCCL rank)"),
                     ("trainer", "Trainer.make_training_loop")):
        print(f"{label}: {ms[w]:.4f} ms per step with the host's work (calls of "
              f"{NCCL_LOOP_STEPS} steps, median of {res['ms'][w]}), {dev_ms[w]:.4f} ms per "
              f"replayed step on the device (idle share {1 - dev_ms[w] / ms[w]:.3f}); launches "
              f"in the warm-up {res['warm_up'][w]}, in each replay {res['per_replay'][w]}")
    eager_ms = float(np.median(res["eager_ms"]))
    print(f"DataParallel.make_training_step (one NCCL rank, eager): {eager_ms:.4f} ms per step "
          f"with the host's work (passes of {NCCL_LOOP_STEPS} steps, median of "
          f"{res['eager_ms']}; idle share {1 - dev_ms['parallel'] / eager_ms:.3f} against the "
          f"replayed step's device time)")
    phase("slice 18: NCCL's collectives replayed from a CUDA graph against eager calls "
          "(one rank)")
    for name, diffs in res["collectives"].items():
        check(diffs == [0.0, 0.0], f"{name}: replays differ from eager calls by {diffs}")
        print(f"{name}: replayed equal to eager on two fills (max abs diff {diffs})")
    print(f"slice 18: {time.time() - t0:.1f} s")
    per_replay = res["per_replay"]["parallel"]
    out = []
    for e in hash_entries:
        k = next((k for k in FIRST_ORDER if e["name"] == KERNELS[k][0]), None)
        if k is not None:
            entry = {key: v for key, v in e.items() if key != "launches_inference"}
            entry.update(name=e["name"] + " (DataParallel loop, one NCCL rank)",
                         launches=res["warm_up"]["parallel"][k] + per_replay[k],
                         launches_per_replay=per_replay[k])
            out.append(entry)
    return out


# Slice 14: third derivatives (kernel GT), the stochastic gather, deep
# FusedMLPs, and Queue 1 item 16 (metrics, profiling, the native loader).
CURVATURE_STEPS = 200         # the curvature fit at the SDF sample's 2^14 points
CURVATURE_BATCH_POW = 14
# The JAX package's run of the same fit on the CPU (tests/curvature_fit_reference.py
# 200 14 ReLU: the SDF sample's model and Adam, its loss plus 1e-3 · mean |H v|²)
# read a first loss of 0.099803 and a mean of the last 10 of 0.030752; the
# floor leaves 0.019 of margin (an untrained model reads about 0.0998).
CURVATURE_LOSS_JAX = 0.030752
CURVATURE_LOSS_FLOOR = 0.05
CURVATURE_CHECK_POW = 14      # the step's gradients against the plain path
DEEP_M_HIDDEN = 40            # FullyFusedMLP 64 x 40: two launches of M, MB in runs
DEEP_M_BATCH = 1 << 16
PREFETCH_STEPS = 200
PREFETCH_PSNR_MARGIN = 2.0    # dB below the same run's on-device-sampler fit
REPLACES_GT = ("none (jnp): autodiff of the backward of _grid_interpolate's custom VJP, "
               "tcnn_tpu/ops/grid_ops.py:917-1122")


def gt_flops(spec, batch, need_x=True):
    """GT with d_dcols, the table gradient and (``need_x``) d_x, counted as
    its 1- to 4-D instances do the work: per (sample, level) the positions
    and per-dim factors and their derivatives (4D) and the (1, s, t, st)
    jets along β and v of each dim's two factors (4 operations each, 8D;
    with d_x those of the factors' derivatives too, 8D more); per corner
    the prefix product of its D jets (D - 1 jet products of 14 operations),
    d dcols (2F) and the table update u·dy and its add (2F); with d_x the
    row's dot with dcols (2F), each prefix times a derivative's jet (D - 1
    products), the suffix products (D - 2), the st coefficients of their
    products (D - 1, 7 each) and d_x's sums (2D)."""
    D, C, F = spec.n_dims, 1 << spec.n_dims, spec.n_features_per_level
    per_level = 12 * D + (8 * D if need_x else 0)
    corner = 14 * (D - 1) + 4 * F
    if need_x:
        corner += 2 * F + 14 * (D - 1) + 14 * max(D - 2, 0) + 7 * (D - 1) + 2 * D
    return batch * spec.n_levels * (per_level + C * corner)


def check_third_order(spec, table, x, dcols, ddx, beta, live, frac=None, shard=None,
                      label=""):
    """Kernel GT against its plain version, with all outputs and with the
    curvature step's (d_dcols and the table gradient, no d_x): d_dcols and
    d_x within 1e-5 of each one's largest magnitude and bit for bit in a
    second launch (one writer per (sample, level), the levels summed in
    one order), the table gradient per entry within 2^-11·S
    (``plain_path.gt_table_scale``, S over its updates' terms, as GG's; one
    bf16 ulp more for a bf16 table) and an exact 0 where S is.  Returns the
    largest max abs err of the outputs of each set, by need_x: all outputs
    (True) and the step's (False)."""
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_third, grid_encode_third_plain
    from tcnn_tpu_torch.tools.plain_path import gt_table_scale

    kw = {"level_frac": frac, "shard": shard}
    scale = gt_table_scale(spec, x, dcols, ddx, beta, live, frac, shard)
    worst = {}
    for need_x, outputs in ((True, "all outputs"), (False, "the step's outputs")):
        what = f"GT {label}, {outputs}"
        with torch.inference_mode():
            got = grid_encode_third(spec, table, x, dcols, ddx, beta, live, need_x=need_x, **kw)
            again = grid_encode_third(spec, table, x, dcols, ddx, beta, live, need_x=need_x,
                                      **kw)
            torch.cuda.synchronize()
            check(torch.equal(got.d_dcols, again.d_dcols)
                  and (not need_x or torch.equal(got.d_x, again.d_x)),
                  f"{what}: d_dcols or d_x differ between two launches")
            check(need_x or got.d_x is None, f"{what}: d_x computed")
            want = grid_encode_third_plain(spec, table, x, dcols, ddx, beta, live,
                                           need_x=need_x, **kw)
            e = compare_rel(got.d_dcols, want.d_dcols, 1e-5, f"{what} d_dcols")
            if need_x:
                e = max(e, compare_rel(got.d_x, want.d_x, 1e-5, f"{what} d_x"))
            e_flat = compare_table_grad(got.d_flat, want.d_flat, scale, f"{what} table grad")
            check(not bool(got.d_flat[scale == 0].any()),
                  f"{what}: table rows no update reaches are not zero")
        print(f"{what}: max abs err d_dcols{', d_x' if need_x else ''} {e:.3e} (1e-5 of each "
              f"max; bit for bit in a second launch), table gradient {e_flat:.3e} (2^-11·S "
              "over its updates' terms)")
        worst[need_x] = max(e, e_flat)
    return worst


def relu_switch_samples(net, x, near):
    """Which of the points x (B, 3) put a hidden ReLU of ``net`` (a grid
    feeding a fused MLP, fp32) near its switch: a pre-activation z with
    |z| <= near · Σ|h·w| in the plain fp32 forward, where a sum in another
    order (kernel M, the streamed layer) may land on the other side of 0.
    Returns a (B,) bool mask."""
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_plain

    enc, mlp = net.encoding, net.network
    spec, ws = enc.spec, [w.detach().float() for w in mlp.layers]
    with torch.no_grad():
        h = grid_encode_plain(spec, enc.grid.detach().float(), x,
                              list(range(spec.n_levels)), soa=True).float().t()
        hit = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
        for w in ws[:-1]:
            z = h @ w
            hit |= (z.abs() <= near * (h.abs() @ w.abs())).any(dim=1)
            h = torch.relu(z)
    return hit


def redraw_relu_switches(net, gen, xs, xv, near, rounds=20):
    """xs and xv with every point that ``relu_switch_samples`` flags drawn
    again from the same distributions (``sample_points``), until none is
    flagged.  Returns (xs, xv, points redrawn)."""
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf

    xs, xv, redrawn = xs.clone(), xv.clone(), 0
    for _ in range(rounds):
        hs, hv = relu_switch_samples(net, xs, near), relu_switch_samples(net, xv, near)
        if not bool(hs.any() or hv.any()):
            return xs, xv, redrawn
        redrawn += int(hs.sum()) + int(hv.sum())
        ns, nv = sdf.sample_points(gen, xs.shape[0], xs.device)
        xs[hs], xv[hv] = ns[hs], nv[hv]
    check(False, f"points near a ReLU switch remain after {rounds} draws")


def curvature_check(gen, dev, act, net=None, n_pow=CURVATURE_CHECK_POW, kernels=(),
                    near=None):
    """One curvature step of the SDF sample's model (``act`` hidden layers;
    ``net``: another model) at 2^n_pow points through the kernels against
    ``plain_path.plain_curvature_loss_and_grads`` (autograd of the plain
    forward): the loss at 1e-4 relative, every gradient, the table's too,
    within 1e-4 of its largest magnitude (the third order's per-entry term
    magnitudes are not formed; a sample whose ReLU switches near 0 moves a
    gradient by 1/2^14 of one sample's share).  ``near``: first the step as
    drawn and, as a control, with as many points clear of a switch replaced
    by copies of other clear points, their gradients' errors printed and
    not held; then the points that ``relu_switch_samples`` flags at
    ``near`` drawn again and the step held on those (ReLU: a switched
    sample moves its whole share of the gradients, which at 2^18 points and
    256 MLP inputs was beyond 1e-4 of the table gradient's largest entry).  Each of G, M, GB, MB, GI, GG and
    GT, and of ``kernels``, must launch.  Returns the step's launches."""
    from tcnn_tpu_torch import Policy, create_from_config
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
    from tcnn_tpu_torch.tools.plain_path import plain_curvature_loss_and_grads

    if net is None:
        cfg = {**sdf.CONFIG, "network": {**sdf.CONFIG["network"], "activation": act}}
        net = create_from_config(3, 1, cfg, policy=Policy()).network
    n = 1 << n_pow
    xs, xv = sdf.sample_points(gen, n, dev)
    v = sdf.sample_directions(gen, n, dev)
    note = ""
    if near is not None:
        def errors(ps, pv):
            _, grads = sdf.curvature_loss_and_grads(net, ps, pv, v)
            _, want = plain_curvature_loss_and_grads(net, ps, pv, v)
            return ", ".join(f"{k.split('.', 1)[1]} {rel_err(g, want[k]):.3e}"
                             for k, g in grads.items())

        def swap_clear(x, hit):   # as many clear points as hit, copies of other clear ones
            clear, k = (~hit).nonzero().flatten(), int(hit.sum())
            perm = torch.randperm(clear.numel(), generator=gen, device=x.device)
            x = x.clone()
            x[clear[perm[:k]]] = x[clear[perm[k:2 * k]]]
            return x

        raw = errors(xs, xv)
        hs, hv = relu_switch_samples(net, xs, near), relu_switch_samples(net, xv, near)
        control = errors(swap_clear(xs, hs), swap_clear(xv, hv))
        xs, xv, redrawn = redraw_relu_switches(net, gen, xs, xv, near)
        note = (f"; not held: as first drawn {raw}; with {int(hs.sum()) + int(hv.sum())} "
                f"points clear of a switch replaced by copies of other clear points "
                f"(the control) {control}; held above: the points within {near:.3g}·Σ|h·w| "
                f"of a ReLU switch drawn again ({redrawn} draws in all)")
    torch.cuda.synchronize()
    reset_counts()
    loss, grads = sdf.curvature_loss_and_grads(net, xs, xv, v)
    torch.cuda.synchronize()
    launches = counts()
    want_loss, want = plain_curvature_loss_and_grads(net, xs, xv, v)
    check(abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item()),
          f"curvature step ({act}): loss {loss.item()} vs plain {want_loss.item()}")
    check(sorted(grads) == sorted(want), f"curvature step gradient names {sorted(grads)}")
    hows = []
    for name, g in grads.items():
        e = compare_rel(g, want[name], 1e-4, f"curvature step ({act}) {name}")
        hows.append(f"{name.split('.', 1)[1]} {e / want[name].abs().max().item():.3e}")
    print(f"curvature step ({act}, 2^{n_pow}): loss {loss.item():.6f}, plain "
          f"{want_loss.item():.6f}; gradients (of each max): {', '.join(hows)}; launches "
          f"{launches}{note}")
    missing = [k for k in ("G", "M", "GB", "MB", "GI", "GG", "GT", *kernels)
               if launches[k] == 0]
    check(not missing and launches["RS"] == 0,
          f"curvature step ({act}): kernels not launched {missing}, launches {launches}")
    return launches


def slice14(gen, dev, hash_times):
    """Slice 14: kernel GT and G's stochastic gather against their plain
    versions, the curvature step (the main path of GT) checked, timed and
    fitted, M and MB beyond one launch's layers, a config_hash fit fed by
    ``PrefetchingSampler``, and one eager eikonal step under
    ``profiling.trace``.  Returns the report entries of GT and the
    stochastic gather."""
    import json
    import re
    import tempfile

    from tcnn_tpu_torch import BF16_POLICY, Policy, create_from_config
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_bwd_plain,
                                                   fused_mlp_bwd_plain,
                                                   fused_mlp_bwd_segmented, fused_mlp_fwd,
                                                   fused_mlp_fwd_chained, fused_mlp_plain,
                                                   mb_plan, plan_runs)
    from tcnn_tpu_torch.ops.cuda.grid_encode import (grid_encode_fwd, grid_encode_plain,
                                                     grid_encode_third,
                                                     grid_encode_third_plain)
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
    from tcnn_tpu_torch.utils import metrics, profiling
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image
    from tcnn_tpu_torch.utils.native_loader import NativeImageSampler, PrefetchingSampler

    t, err = {}, {}
    model = create_from_config(3, 1, sdf.CONFIG, policy=Policy())
    net, opt = model.network, model.optimizer
    spec = net.encoding.spec
    live = list(range(spec.n_levels))
    with torch.no_grad():
        net.encoding.grid.uniform_(-1, 1, generator=gen)
    table = net.encoding.grid.detach()
    B, D = MAIN_BATCH, spec.n_dims
    phase(f"slice 14: GT vs plain in each instance family, all outputs and the curvature "
          f"step's: the SDF grid (fp32, {spec.n_levels} levels x {spec.n_features_per_level}, "
          f"{spec.levels[-1].size} rows) at B={B} and 2^14, config_btf's 4-D grid (bf16) at "
          "2^14, the SDF grid with the Rng hash, a mask at 0.5 and shard 0 of 2")
    x = torch.rand((B, D), generator=gen, device=dev) * 0.9 + 0.05
    dcols = torch.randn((spec.n_output_dims, B), generator=gen, device=dev)
    ddx, beta = (torch.randn((B, D), generator=gen, device=dev) for _ in range(2))
    n14 = 1 << 14
    a14 = (x[:n14], dcols[:, :n14].contiguous(), ddx[:n14], beta[:n14])
    sdf_err = check_third_order(spec, table, x, dcols, ddx, beta, live, label="SDF 2^18")
    err["GT sdf"], err["GT sdf step outputs"] = sdf_err[True], sdf_err[False]
    # the other entries are timed with all outputs, so their errors are those
    err["GT sdf 2^14"] = check_third_order(spec, table, *a14, live, label="SDF 2^14")[True]
    btf_spec = create_from_config(6, 3, BTF_CONFIG, policy=BF16_POLICY).network.encoding \
        .nested[0].spec
    btf_table = (torch.rand(btf_spec.n_params, generator=gen, device=dev) * 2 - 1).to(
        torch.bfloat16)
    # a column slice of a (B, 6) input, read in place, as config_btf's grid reads it
    btf_x = torch.rand((n14, 6), generator=gen, device=dev)[:, :btf_spec.n_dims]
    btf_a = (btf_x, torch.randn((btf_spec.n_output_dims, n14), generator=gen, device=dev).to(
        torch.bfloat16), *(torch.randn((n14, btf_spec.n_dims), generator=gen, device=dev)
                           for _ in range(2)))
    btf_live = list(range(btf_spec.n_levels))
    err["GT config_btf"] = check_third_order(
        btf_spec, btf_table, *btf_a, btf_live, label="config_btf 4-D CoherentAdd, bf16, 2^14")[True]
    rng_spec = create_from_config(3, 1, {**sdf.CONFIG, "encoding": {
        **sdf.CONFIG["encoding"], "hash": "Rng"}}, policy=Policy()).network.encoding.spec
    err["GT sdf Rng"] = check_third_order(
        rng_spec, table, *a14, live, label="SDF grid, Rng hash, 2^14 (run-time-D instance)")[True]
    shard = (0, 2)
    perm = torch.from_numpy(grid_ops.block_cyclic_perm(spec, 2)).to(dev)
    shard_table = table[perm].chunk(2)[0].clone()
    err["GT sdf shard"] = check_third_order(spec, shard_table, *a14, live, shard=shard,
                                            label="SDF 2^14, shard 0 of 2")[True]
    half = torch.full((B,), 0.5, device=dev)
    err["GT sdf masked"] = check_third_order(spec, table, x, dcols, ddx, beta, live, half,
                                             label="SDF 2^18, mask at 0.5")[True]

    phase("slice 14: G's stochastic gather vs plain at the Rng and stochastic config_hash "
          f"geometry, B={B}")
    cfg = json.loads(re.sub(r"//[^\n]*", "", open(CONFIG).read()))
    cfg["encoding"] = {**cfg["encoding"], "hash": "Rng", "stochastic_interpolation": True}
    # Softplus: a ReLU MLP's input gradient does not depend on x, and the
    # one-hot weights do not either, so the loss below would not depend on x
    cfg["network"] = {**cfg["network"], "activation": "Softplus"}
    st_model = create_from_config(2, 3, cfg, policy=BF16_POLICY)
    st_enc = st_model.network.encoding
    st_spec = st_enc.spec
    st_live = list(range(st_spec.n_levels))
    with torch.no_grad():
        st_enc.grid.uniform_(-1, 1, generator=gen)
    xs2 = torch.rand((B, 2), generator=gen, device=dev)
    e_sg = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        u = st_enc.grid.detach().to(dtype)
        with torch.inference_mode():
            got = grid_encode_fwd(st_spec, u, xs2, st_live, soa=True, stochastic=True)
            torch.cuda.synchronize()
            want = grid_encode_plain(st_spec, u, xs2, st_live, soa=True, stochastic=True)
        e_sg = max(e_sg, compare(got, want, "grid-bf16" if dtype == torch.bfloat16
                                 else "grid-f32")[0])
        check(torch.equal(got, want), f"stochastic gather ({dtype}): not the plain bits")
    err["G stochastic gather"] = e_sg
    print(f"G's stochastic gather: max abs err {e_sg:.3e}, the plain version's bits in fp32 "
          "and bf16 (one corner at weight 1)")
    # its main path: a loss on the stochastic grid's table gradient, in x
    torch.cuda.synchronize()
    reset_counts()
    xg = xs2.clone().requires_grad_()
    (dt,) = torch.autograd.grad(st_model.network(xg).float().sum(), st_enc.grid,
                                create_graph=True)
    (dxg,) = torch.autograd.grad(dt.float().square().sum(), xg)
    torch.cuda.synchronize()
    st_launches = counts()
    check(bool(torch.isfinite(dxg).all()), "stochastic cotangent: non-finite d x")
    check(st_launches["G"] == 2, f"stochastic cotangent launches {st_launches}: expected G "
          "twice (the forward and the stochastic gather)")
    print(f"loss on the stochastic table gradient, d/dx at B={B}: launches {st_launches}")
    with torch.inference_mode():
        u = st_enc.grid.detach().to(torch.bfloat16)
        sg_out = grid_encode_fwd(st_spec, u, xs2, st_live, soa=True, stochastic=True)
        key = "G stochastic gather"
        t[key] = graph_ms(lambda: grid_encode_fwd(st_spec, u, xs2, st_live, soa=True,
                                                  stochastic=True))
        t[key + " plain"] = eager_ms(lambda: grid_encode_plain(st_spec, u, xs2, st_live,
                                                               soa=True, stochastic=True))
    idx_st, ws_st = grid_ops.build_indices_weights(st_spec, xs2, st_live, scatter=True)
    picks = ws_st.reshape(st_spec.n_levels, 4, B).argmax(dim=1)
    picked = idx_st.reshape(st_spec.n_levels, 4, B).gather(1, picks[:, None]).flatten()
    consts = st_spec.n_levels * grid_ops.LEVEL_FIELDS * 4
    # bytes: x, the uniforms and the rows of the picked corners (one a (sample,
    # level)); operations: positions and per-dim weights, the pick, and the
    # picked corner's Rng hash
    sg_bytes = (nbytes(xs2, sg_out) + st_spec.n_levels * B * 4 + consts
                + int(picked.unique().numel()) * st_spec.n_features_per_level * 2)
    sg_ops = B * st_spec.n_levels * 6 * 2 + rng_hash_ops(st_spec, xs2, picks)
    t[key + " bound"] = bound_ms(sg_bytes, sg_ops, PEAK_FP32)
    t[key + " bound by"] = bound_by(sg_bytes, sg_ops, PEAK_FP32)
    print(f"{key}: {t[key]:.4f} ms on the device (plain {t[key + ' plain']:.4f} ms, bound "
          f"{t[key + ' bound']:.4f} ms: {sg_bytes / 1e6:.2f} MB, {sg_ops / 1e9:.3f} G "
          f"operations)")

    phase(f"slice 14: the curvature step (eikonal + {sdf.CURVATURE_WEIGHT} · mean |H v|^2) of "
          f"the SDF model, ReLU and Softplus, at 2^{CURVATURE_CHECK_POW} against the plain path")
    step_launches = {act: curvature_check(gen, dev, act) for act in ("ReLU", "Softplus")}
    check(all(n["GT"] == 1 for n in step_launches.values()),
          f"curvature step: GT launches {step_launches}, expected one a step")

    phase(f"slice 14: {CURVATURE_STEPS} curvature steps at 2^{CURVATURE_BATCH_POW} "
          "(ReLU, the SDF sample's model): the main path")
    fit_model = create_from_config(3, 1, sdf.CONFIG, policy=Policy())
    fnet, fopt = fit_model.network, fit_model.optimizer
    fstate = fopt.init(dict(fnet.named_parameters()), fnet.param_layout())
    fgen = torch.Generator(dev).manual_seed(1)
    nfit = 1 << CURVATURE_BATCH_POW
    losses = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(CURVATURE_STEPS):
        xs, xv = sdf.sample_points(fgen, nfit, dev)
        v = sdf.sample_directions(fgen, nfit, dev)
        loss, grads = sdf.curvature_loss_and_grads(fnet, xs, xv, v)
        fopt.step(fstate, grads, dict(fnet.named_parameters()))
        losses.append(loss)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = counts()
    losses = torch.stack(losses).cpu()
    check(bool(torch.isfinite(losses).all()), "non-finite curvature fit loss")
    first, last10 = float(losses[0]), float(losses[-10:].mean())
    print(f"curvature fit: loss {first:.6f} -> {last10:.6f} (mean of the last 10; JAX "
          f"{CURVATURE_LOSS_JAX}, floor {CURVATURE_LOSS_FLOOR}); {fit_s:.2f} s, "
          f"{fit_s / CURVATURE_STEPS * 1e3:.3f} ms per eager step; launches {fit_launches}")
    check(last10 < CURVATURE_LOSS_FLOOR,
          f"curvature loss floor missed: {last10} >= {CURVATURE_LOSS_FLOOR}")
    check(fit_launches["GT"] == CURVATURE_STEPS * step_launches["ReLU"]["GT"],
          f"curvature fit GT launches {fit_launches['GT']}, expected "
          f"{CURVATURE_STEPS} x {step_launches['ReLU']['GT']}")

    phase(f"slice 14 times at B={B}: the curvature step (ReLU) in a CUDA graph and eager, "
          "GT and its plain version")
    xs, xv = sdf.sample_points(gen, B, dev)
    v = sdf.sample_directions(gen, B, dev)
    state = opt.init(dict(net.named_parameters()), net.param_layout())

    def curvature_step():
        _, g = sdf.curvature_loss_and_grads(net, xs, xv, v)
        opt.step(state, g, dict(net.named_parameters()))

    t["curvature step"] = time_ms(curvature_step, n=10)
    t["curvature step device"] = graph_ms(curvature_step, n=5)
    estate = opt.init(dict(net.named_parameters()), net.param_layout())

    def eikonal_step():
        sdf.step(net, opt, estate, xs, xv)

    t["eikonal step"] = time_ms(eikonal_step, n=10)
    t["eikonal step device"] = graph_ms(eikonal_step, n=5)
    # The MLP's part (torch operations, no kernel): its second order as the
    # eikonal step runs it, and the same with its graph kept and
    # differentiated once more in the weights and the features, as the
    # curvature step's third order runs it.
    mlp = net.network
    mws = [w.detach() for w in mlp.layers]
    with torch.no_grad():
        fv = grid_encode_fwd(spec, table, xv, live, soa=True)
    ones = torch.ones((B, 1), device=dev)
    ct_f = torch.randn(fv.shape, generator=gen, device=dev)
    mlp_args = (mlp.activation, mlp.output_activation, torch.float32, torch.float32, True, False)

    def mlp_second():
        return fused_mlp_bwd_bwd_plain(mws, fv, ones, ct_f, [None] * len(mws), *mlp_args)

    def mlp_third():
        leaves = [w.clone().requires_grad_() for w in mws] + [fv.clone().requires_grad_()]
        d_x, _, d_ws = fused_mlp_bwd_bwd_plain(leaves[:-1], leaves[-1], ones, ct_f,
                                               [None] * len(mws), *mlp_args, create_graph=True)
        outs = [o for o in (d_x, *d_ws) if o is not None and o.requires_grad]
        return torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs],
                                   allow_unused=True)

    t["MLP second order"] = graph_ms(mlp_second)
    t["MLP third order"] = graph_ms(mlp_third)
    print(f"the MLP's part at B={B} (torch operations): its second order "
          f"{t['MLP second order']:.4f} ms on the device; kept and differentiated once more "
          f"{t['MLP third order']:.4f} ms")
    sdf_args = (spec, table, x, dcols, ddx, beta, live)
    calls = {"GT sdf": (sdf_args, {}),
             "GT sdf step outputs": (sdf_args, {"need_x": False}),
             "GT sdf 2^14": ((spec, table, *a14, live), {}),
             "GT config_btf": ((btf_spec, btf_table, *btf_a, btf_live), {}),
             "GT sdf Rng": ((rng_spec, table, *a14, live), {}),
             "GT sdf shard": ((spec, shard_table, *a14, live), {"shard": shard}),
             "GT sdf masked": (sdf_args, {"level_frac": half})}
    outs = {}
    with torch.inference_mode():
        for k, (a, kw) in calls.items():
            outs[k] = [o for o in grid_encode_third(*a, **kw) if o is not None]
            t[k] = graph_ms(lambda: grid_encode_third(*a, **kw))
            t[k + " plain"] = eager_ms(lambda: grid_encode_third_plain(*a, **kw), n=2)
    idx14, _ = grid_ops.build_indices_weights(spec, a14[0], live, shard=shard)
    owned = float((idx14 >= 0).float().mean())   # the corners the shard holds
    kept = float((torch.arange(spec.n_levels, device=dev).float()
                  < 0.5 * spec.n_levels + 1e-3).float().mean())   # levels the mask keeps
    # each input read once (x, ddx, β, dcols, the touched table rows), each
    # output asked for written once (d_dcols, d_x, the table gradient);
    # gt_flops for the (sample, level, corner) work this run's data needs
    b = {}
    for k, (a, kw) in calls.items():
        gspec, elem = a[0], a[1].element_size()
        b[k] = (nbytes(*a[2:6], *outs[k]) + touched_bytes(gspec, a[2], elem, kw.get("shard"))
                + gspec.n_levels * grid_ops.LEVEL_FIELDS * 4,
                gt_flops(gspec, a[2].shape[0], kw.get("need_x", True))
                * (owned if "shard" in kw else 1.0) * (kept if "level_frac" in kw else 1.0))
    for k, (n_bytes, ops) in b.items():
        t[k + " bound"] = bound_ms(n_bytes, ops, PEAK_FP32)
        t[k + " bound by"] = bound_by(n_bytes, ops, PEAK_FP32)
        print(f"{k}: {t[k]:.4f} ms on the device (plain {t[k + ' plain']:.4f} ms, bound "
              f"{t[k + ' bound']:.4f} ms: {n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} G "
              "operations on the fp32 units)")
    per = step_launches["ReLU"]
    print(f"curvature step at B={B} (ReLU): {t['curvature step']:.4f} ms eager with the "
          f"host's work, {t['curvature step device']:.4f} ms of device work (idle share "
          f"{1 - t['curvature step device'] / t['curvature step']:.3f}); launches per step "
          + ", ".join(f"{k} {per[k]}" for k in ("G", "M", "GB", "MB", "GI", "GG", "GT"))
          + f"; Softplus {step_launches['Softplus']}")
    print(f"eikonal step at B={B} (ReLU, the same model): {t['eikonal step']:.4f} ms eager, "
          f"{t['eikonal step device']:.4f} ms of device work")

    phase(f"slice 14: M and MB at 64 x {DEEP_M_HIDDEN} hidden layers, B={DEEP_M_BATCH}, "
          "against the plain versions and a chain of shallow launches")
    relu, none = Activation.RELU, Activation.NONE
    dims = mlp_dims(32, 64, DEEP_M_HIDDEN)
    ws = random_mlp(gen, dev, dims)
    xm = torch.rand((32, DEEP_M_BATCH), generator=gen, device=dev) * 2 - 1
    gm = torch.randn((DEEP_M_BATCH, 3), generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        key = f"64 x {DEEP_M_HIDDEN}, {str(dtype)[6:]}"
        margs = (ws, xm.to(dtype), relu, none, dtype, torch.float32, True, False)
        with torch.inference_mode():
            m0 = fused_mlp_fwd.launches
            y = fused_mlp_fwd(*margs)
            torch.cuda.synchronize()
            m_n, mb0 = fused_mlp_fwd.launches - m0, fused_mlp_bwd.launches
            dws, dxm = fused_mlp_bwd(ws, xm.to(dtype), gm, relu, none, dtype, True, False)
            torch.cuda.synchronize()
            mb_n = fused_mlp_bwd.launches - mb0
            runs = [(i, min(i + 5, len(ws))) for i in range(0, len(ws) - 6, 5)]
            runs.append((runs[-1][1], len(ws)))
            shallow = fused_mlp_fwd_chained(*margs, runs, fwd=fused_mlp_fwd)
            want_y = fused_mlp_plain(*margs)
            want_dws, want_dx = fused_mlp_bwd_plain(ws, xm.to(dtype), gm, relu, none, dtype,
                                                    True, False)
            dws_s, dx_s = fused_mlp_bwd_segmented(ws, xm.to(dtype), gm, relu, none, dtype,
                                                  True, False, runs)
        check(m_n == len(plan_runs(len(ws), lambda a, b: True)) == 2, f"M {key}: {m_n} launches, expected 2")
        check(mb_n == len(mb_plan(ws, dtype, relu, none)) and mb_n >= 2,
              f"MB {key}: {mb_n} launches")
        check(torch.equal(y, shallow), f"M {key}: not the bits of a chain of shallow launches")
        if dtype == torch.float32:
            e_m = compare(y, want_y, "mlp-f32")[0]
            e_mb = compare_mlp_grads([*dws, dxm], [*want_dws, want_dx], dtype, f"MB {key}")
            how = "M within the fp32 MLP bound; MB every dW and dx within 1e-4 of its max"
        else:   # bf16 roundings compound over 41 layers: the shallow runs' bits
            e_m = (y - want_y).abs().max().item()
            e_mb = max((a - b).abs().max().item() for a, b in zip([*dws, dxm],
                                                                  [*want_dws, want_dx]))
            rel = max(((a.float() - b.float()).norm() / b.float().norm()).item()
                      for a, b in zip([*dws, dxm], [*want_dws, want_dx]))
            check(torch.equal(dxm, dx_s) and all(torch.equal(a, b) for a, b in zip(dws, dws_s)),
                  f"MB {key}: not the bits of launches over runs of five layers")
            how = (f"M and MB bit for bit against launches over runs of five layers; against "
                   f"plain M max abs err {e_m:.3e}, MB relative L2 error up to {rel:.3e} "
                   f"(bf16 roundings compound over 41 layers)")
        print(f"{key}: M {m_n} launches, bit for bit against {len(runs)} shallow launches, "
              f"max abs err {e_m:.3e}; MB {mb_n} launches, max abs err {e_mb:.3e} ({how})")

    phase(f"slice 14: config_hash fed by PrefetchingSampler (the native loader) from "
          f"synthetic_image(1024, 1024), {PREFETCH_STEPS} training_steps at B={B}, against "
          "the same fit on the on-device sampler")
    image = synthetic_image(1024, 1024)
    fits = {}
    for source in ("on-device sampler", "PrefetchingSampler"):
        hmodel = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
        if source == "on-device sampler":
            sampler = ImageSampler(image, seed=0)
            batches = (sampler.sample_batch(B) for _ in range(PREFETCH_STEPS))
            close = None
        else:
            pre = PrefetchingSampler(NativeImageSampler(image), B, seed=0, depth=2)
            batches = (next(pre) for _ in range(PREFETCH_STEPS))
            close = pre.close
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        step_losses = [hmodel.trainer.training_step(xb, yb) for xb, yb in batches]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = first_order_counts()
        if close:
            close()
        with torch.inference_mode():
            pred = hmodel.trainer.inference(ImageSampler(image, seed=0).full_grid_coords())
        fits[source] = {"ms": sec / PREFETCH_STEPS * 1e3,
                        "psnr": metrics.mse2psnr(metrics.mean_MSE(
                            pred, torch.from_numpy(image).to(dev).reshape(-1, 3))),
                        "loss": float(torch.stack(step_losses[-10:]).mean())}
        check(launches == {"G": PREFETCH_STEPS, "M": PREFETCH_STEPS, "GB": PREFETCH_STEPS,
                           "MB": PREFETCH_STEPS}, f"{source} fit launches {launches}")
        print(f"{source}: {fits[source]['ms']:.4f} ms per eager training_step, PSNR "
              f"{fits[source]['psnr']:.2f} dB (metrics.mean_MSE), loss of the last 10 "
              f"{fits[source]['loss']:.6f}; launches {launches}")
    floor = fits["on-device sampler"]["psnr"] - PREFETCH_PSNR_MARGIN
    check(fits["PrefetchingSampler"]["psnr"] > floor,
          f"PrefetchingSampler fit PSNR {fits['PrefetchingSampler']['psnr']:.2f} dB below "
          f"the floor {floor:.2f} (the on-device sampler's fit less {PREFETCH_PSNR_MARGIN})")
    print(f"make_training_loop's replayed step in this run: {hash_times['loop step']:.4f} ms")

    phase(f"slice 14: one eager eikonal step at B={B} under profiling.trace")
    sxs, sxv = sdf.sample_points(gen, B, dev)
    sstate = opt.init(dict(net.named_parameters()), net.param_layout())
    sdf.step(net, opt, sstate, sxs, sxv)   # warm
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as trace_dir:
        with profiling.trace(trace_dir) as prof, profiling.Timer() as timer:
            sdf.step(net, opt, sstate, sxs, sxv)
        split = profiling.split(prof)
        trace_mb = os.path.getsize(prof.trace_file) / 1e6
    print(f"eikonal step under the profiler: {timer.seconds * 1e3:.3f} ms on the host clock; "
          f"CUDA kernels {split['device_ms']:.4f} ms of device time "
          f"({'not measured: no device activity recorded' if not split['device_ms'] else 'CUPTI'}), "
          f"CPU ops' self time {split['cpu_ms']:.3f} ms; trace {trace_mb:.1f} MB")
    for name, ms, n in split["top_cpu"]:
        print(f"  CPU self time: {name} {ms:.4f} ms in {n} calls")
    mem = profiling.device_memory_stats()
    print(f"device_memory_stats: peak allocated {mem.get('allocated_bytes.all.peak', 0) / 1e6:.1f}"
          " MB")

    out = entries(t, [("GT sdf", "GT", REPLACES_GT)], {"GT": fit_launches["GT"]}, err,
                  {"launches_per_step": per["GT"], "batch": B, "outputs": "all"})
    for key, extra in (("GT sdf step outputs", {"batch": B, "outputs": "d_dcols, table"}),
                       ("GT sdf 2^14", {"batch": n14}),
                       ("GT config_btf", {"batch": n14, "dtype": "bfloat16"}),
                       ("GT sdf Rng", {"batch": n14, "hash": "Rng"}),
                       ("GT sdf shard", {"batch": n14, "shard": [0, 2]}),
                       ("GT sdf masked", {"batch": B, "level_frac": 0.5})):
        out += entries(t, [(key, "GT", REPLACES_GT)], {"GT": fit_launches["GT"]}, err, extra)
    out += entries(t, [("G stochastic gather", "G", REPLACES_G)], {"G": st_launches["G"]},
                   err, {"path": "d/dx of a loss on the stochastic grid's table gradient: G "
                                 "once forward, once gathering"})
    return out


WIDE_ROWS_POW = 19        # the wide SDF's tables: 2^19 rows a level, 74,607,488 parameters
WIDE_KERNEL_POW = 16      # the grid kernels at F = 16 and 32 against their plain versions
WIDE_STEP_POW = 18        # the wide SDF's eikonal and curvature steps against the plain path
WIDE_RELU_NEAR = 2.0 ** -14   # 4x the worst-case fp32 error of 256 products, of Σ|h·w|
WIDE_FIT_STEPS = 200
WIDE_FIT_POW = 14
# The fit's tables hold 2^15 rows a level (5,927,936 parameters), so that the
# JAX package's run of the same fit runs on a CPU host at the same size
# (tests/wide_sdf_fit_reference.py 200 14 15: the SDF sample's model and
# Adam with the wide grid and network; first loss 0.091757, a mean of the
# last 10 of 0.017524).  The floor is the SDF
# sample's, 0.05: an untrained model reads about 0.09.
WIDE_FIT_ROWS_POW = 15
WIDE_FIT_LOSS_JAX = 0.017524
WIDE_FIT_LOSS_FLOOR = 0.05
WIDE_IMAGE_F = 32         # config_hash's grid at 32 features a level: 512 MLP inputs
WIDE_IMAGE_STEPS = 100
REPLACES_M = "tcnn_tpu/ops/pallas/fused_mlp.py:100 (_fwd_kernel)"


def wide_sdf_config(log2_rows):
    """The SDF sample's config with a 3-D grid of 16 levels x 16 features and
    a FullyFusedMLP 128 x 2 (256 inputs; tests/wide_sdf_fit_reference.py's
    ``wide_config``)."""
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf

    return {**sdf.CONFIG,
            "encoding": {**sdf.CONFIG["encoding"], "n_levels": 16, "n_features_per_level": 16,
                         "log2_hashmap_size": log2_rows},
            "network": {**sdf.CONFIG["network"], "n_neurons": 128, "n_hidden_layers": 2}}


def wide_image_config():
    """config_hash's grid geometry at ``WIDE_IMAGE_F`` features a level into a
    FullyFusedMLP 128 x 2 (512 inputs)."""
    import json
    import re

    cfg = json.loads(re.sub(r"//[^\n]*", "", open(CONFIG).read()))
    cfg["encoding"] = {**cfg["encoding"], "n_features_per_level": WIDE_IMAGE_F}
    cfg["network"] = {**cfg["network"], "n_neurons": 128, "n_hidden_layers": 2}
    return cfg


def gt_time(spec, table, x, dcols, ddx, beta, t, key):
    """Kernel GT's device time with all outputs, its plain version's and its
    bound (``gt_flops``; each input read once, each output written once)
    into t."""
    from tcnn_tpu_torch.ops import grid_ops
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_third, grid_encode_third_plain

    live = list(range(spec.n_levels))
    a = (spec, table, x, dcols, ddx, beta, live)
    with torch.inference_mode():
        outs = [o for o in grid_encode_third(*a) if o is not None]
        t[key] = graph_ms(lambda: grid_encode_third(*a))
        t[key + " plain"] = eager_ms(lambda: grid_encode_third_plain(*a), n=2)
    n_bytes = (nbytes(x, dcols, ddx, beta, *outs)
               + touched_bytes(spec, x, table.element_size())
               + spec.n_levels * grid_ops.LEVEL_FIELDS * 4)
    ops = gt_flops(spec, x.shape[0])
    t[key + " bound"] = bound_ms(n_bytes, ops, PEAK_FP32)
    t[key + " bound by"] = bound_by(n_bytes, ops, PEAK_FP32)
    print(f"{key}: {t[key]:.4f} ms on the device (plain {t[key + ' plain']:.4f} ms, bound "
          f"{t[key + ' bound']:.4f} ms: {n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} G operations "
          "on the fp32 units)")


def mlp_width_limits():
    """The widest input and output that one launch of kernel M and of kernel
    MB takes, from the kernels' own shared-memory layouts
    (``fused_mlp_fwd_smem_bytes``, ``fused_mlp_bwd_smem_bytes``): ReLU, SoA
    input, three layers (one output) for the inputs, 32 inputs and three or
    six layers for the outputs; the largest n such that every width up to
    n fits.  Printed; returns nothing."""
    from tcnn_tpu_torch.ops.cuda import fused_mlp as fm

    k = fm.kernels()

    def largest(fits, top=4096):
        n = 0
        while n < top and fits(n + 1):
            n += 1
        return n

    for width in (64, 128):
        for bf16 in (False, True):
            m_in = largest(lambda d: k.fused_mlp_fwd_smem_bytes(d, 1, width, 3, bf16, True)
                           <= fm.MAX_SMEM)
            mb_in = largest(lambda d: k.fused_mlp_bwd_smem_bytes(d, 1, width, 3, bf16, 1, 0)
                            <= fm.MAX_SMEM)
            outs = [largest(lambda o: k.fused_mlp_fwd_smem_bytes(32, o, width, n, bf16, True)
                            <= fm.MAX_SMEM and k.fused_mlp_bwd_smem_bytes(
                                32, o, width, n, bf16, 1, 0) <= fm.MAX_SMEM)
                    for n in (3, 6)]
            print(f"one launch, width {width}, {'bf16' if bf16 else 'fp32'}: inputs up to "
                  f"{m_in} (M) and {mb_in} (MB) at three layers; outputs up to {outs[0]} "
                  f"(three layers) and {outs[1]} (six) for M and MB both")


def wide_mlp_checks(gen, dev, d_in, d_out, dtype, tag, t, err):
    """M and MB at d_in -> 128 x 2 -> d_out (B = 2^18, SoA input) against
    their plain versions (``mlp_case``, ``mlp_bwd_case``), the runs they
    take (``m_plan``, ``mb_plan``), the streamed-layer instances alone on
    the first layer against theirs (y at the MLP bounds, dW and dx within
    1e-4 or 2e-2 of each largest magnitude; dW bit for bit in a second
    launch), and the times of all four beside their plain versions, their
    bounds and the cuBLAS products of the same work."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_plain,
                                                   fused_mlp_bwd_segmented, fused_mlp_fwd,
                                                   fused_mlp_plain, fused_mlp_wide_bwd,
                                                   fused_mlp_wide_fwd, m_plan, mb_plan)

    B, relu, none = MAIN_BATCH, Activation.RELU, Activation.NONE
    dims = mlp_dims(d_in, 128, 2, d_out)
    phase(f"slice 16: M and MB at {d_in} -> 128 x 2 -> {d_out} ({str(dtype)[6:]}) vs plain "
          f"at B={B}, and their streamed-layer instances")
    # 512 bf16 inputs: a hidden value may round to the other neighbour, as at
    # config_oneblob's depth (rows that the plain version's rounding explains)
    err[f"M {tag}"] = mlp_case(gen, dev, dims, B, dtype, rounding=True)
    err[f"MB {tag}"] = mlp_bwd_case(gen, dev, dims, B, dtype, flips=True)
    ws = random_mlp(gen, dev, dims)
    wc = [w.to(dtype) for w in ws]
    m_runs, mb_runs = m_plan(wc, dtype, True), mb_plan(wc, dtype, relu, none)
    print(f"{tag}: kernel M's runs {m_runs}, MB's {mb_runs} (a run of one layer: the "
          "streamed-layer instance)")
    check(any(b - a == 1 for a, b in m_runs + mb_runs),
          f"{tag}: no run of one layer in M's {m_runs} or MB's {mb_runs}")
    x = (torch.rand((d_in, B), generator=gen, device=dev) * 2 - 1).to(dtype)
    g = torch.randn((B, d_out), generator=gen, device=dev)
    g1 = torch.randn((B, 128), generator=gen, device=dev)   # layer 0's output gradient
    tol = "mlp-bf16" if dtype == torch.bfloat16 else "mlp-f32"
    with torch.inference_mode():
        w_args = (ws[0], x, relu, dtype, dtype, True, False)
        got = fused_mlp_wide_fwd(*w_args)
        torch.cuda.synchronize()
        err[f"MW {tag}"] = compare(got.float(), fused_mlp_plain(
            [ws[0]], x, relu, relu, dtype, dtype, True, False).float(), tol)[0]
        wb_args = (ws[0], x, g1, relu, dtype, True, False, torch.float32)
        dw, dx = fused_mlp_wide_bwd(*wb_args)
        dw2, dx2 = fused_mlp_wide_bwd(*wb_args)
        torch.cuda.synchronize()
        check(torch.equal(dw, dw2) and torch.equal(dx, dx2),
              f"MBW {tag}: dW or dx differs between two launches")
        want_dws, want_dx = fused_mlp_bwd_plain([ws[0]], x, g1, relu, relu, dtype, True, False,
                                                torch.float32)
        if dtype == torch.bfloat16:
            # MW's bf16 z is a tensor-core sum, in another order than the
            # plain product's: a pre-activation within rounding of 0 may
            # switch the layer's ReLU, which moves that sample's dx row (as
            # at MB's hidden layers).  Such rows are held as MB's are, by
            # compare_input_grad: the layer followed by an identity with no
            # activation is the same backward (dz = bf16(g) · mask either
            # way), and relu_flip_rows flips that mask.
            eye = torch.eye(ws[0].shape[1], device=dev)
            err[f"MBW {tag}"] = max(
                compare_mlp_grads([dw], [want_dws[0]], dtype, f"MBW {tag} dW"),
                compare_input_grad(dx, want_dx, [ws[0], eye], x, g1, none, soa_in=True,
                                   what=f"MBW {tag} dx", dtype=dtype)[0])
        else:
            err[f"MBW {tag}"] = compare_mlp_grads([dw, dx], [want_dws[0], want_dx], dtype,
                                                  f"MBW {tag}")
    print(f"streamed layer {d_in} -> 128 ({str(dtype)[6:]}): MW's max abs err "
          f"{err[f'MW {tag}']:.3e}, MBW's {err[f'MBW {tag}']:.3e} (dW and dx; both bit for "
          "bit in a second launch)")
    hs = chain_activations(wc, x.t())
    m_args = (ws, x, relu, none, dtype, torch.float32, True, False)
    mb_args = (ws, x, g, relu, none, dtype, True, False)
    w0 = wc[0]
    with torch.inference_mode():
        t[f"M {tag}"] = graph_ms(lambda: fused_mlp_fwd(*m_args))
        t[f"M {tag} plain"] = eager_ms(lambda: fused_mlp_plain(*m_args))
        t[f"M {tag} library"] = graph_ms(lambda: library_chain(wc, x.t()))
        t[f"MB {tag}"] = graph_ms(lambda: fused_mlp_bwd(*mb_args))
        t[f"MB {tag} plain"] = eager_ms(lambda: fused_mlp_bwd_plain(*mb_args))
        t[f"MB {tag} library"] = graph_ms(lambda: library_bwd(wc, hs, g))
        t[f"MW {tag}"] = graph_ms(lambda: fused_mlp_wide_fwd(*w_args))
        t[f"MW {tag} plain"] = eager_ms(lambda: fused_mlp_plain([ws[0]], x, relu, relu, dtype,
                                                                dtype, True, False))
        t[f"MW {tag} library"] = graph_ms(lambda: torch.relu(x.t() @ w0))
        t[f"MBW {tag}"] = graph_ms(lambda: fused_mlp_wide_bwd(*wb_args))
        t[f"MBW {tag} plain"] = eager_ms(lambda: fused_mlp_bwd_plain(
            [ws[0]], x, g1, relu, relu, dtype, True, False, torch.float32))
        t[f"MBW {tag} library"] = graph_ms(lambda: library_bwd([w0], [x.t()], g1))
        if len(mb_runs) == 1:
            # a finding, not a route: MB whole against the streamed first
            # layer and MB over the rest (M at the boundary), which the
            # planner does not take where the shape fits MB
            t[f"MB {tag} streamed route"] = graph_ms(lambda: fused_mlp_bwd_segmented(
                *mb_args, [(0, 1), (1, len(ws))]))
            print(f"MB {tag}: {t[f'MB {tag}']:.4f} ms whole; {t[f'MB {tag} streamed route']:.4f} "
                  "ms as MW, MBW on the first layer and M, MB over the rest")
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    m_flops = 2 * B * sum(w.numel() for w in ws)
    l_flops = 2 * B * ws[0].numel()
    y_bytes, h1_bytes = B * d_out * 4, B * 128 * x.element_size()   # fp32 y; h1 in dtype
    b = {f"M {tag}": (nbytes(x, *wc) + y_bytes, m_flops),
         f"MB {tag}": (nbytes(x, g, *wc, x) + sum(w.numel() for w in ws) * 4, 3 * m_flops),
         f"MW {tag}": (nbytes(x, w0) + h1_bytes, l_flops),
         f"MBW {tag}": (nbytes(x, w0, g1, dx, dw), 3 * l_flops)}
    for k, (n_bytes, flops) in b.items():
        t[k + " bound"] = bound_ms(n_bytes, flops, peak)
        t[k + " bound by"] = bound_by(n_bytes, flops, peak)
        units = f"on the {UNIT[peak]}"
        if k.startswith("MBW"):
            units = wide_bwd_bound(t, k, n_bytes, l_flops, dtype)
        print(f"{k}: {t[k]:.4f} ms on the device (plain {t[k + ' plain']:.4f} ms, cuBLAS "
              f"products {t[k + ' library']:.4f} ms, bound {t[k + ' bound']:.4f} ms: "
              f"{n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP {units})")


def wide_bwd_bound(t, key, n_bytes, flops, dtype):
    """Kernel MBW's bound into t: bytes over HBM, or its three products of
    ``flops`` each on the units that run them (csrc/fused_mlp_wide.cu): the
    bf16 tensor cores; in fp32 the forward's z on the FMA units and dx and
    dW in 3xTF32, three TF32 products each, with the bound of all three on
    the FMA units kept beside it (``bound fma``).  Returns the units' words."""
    if dtype == torch.bfloat16:
        ops_s, units = 3 * flops / PEAK_BF16, "on the bf16 tensor cores"
    else:
        ops_s = flops / PEAK_FP32 + 2 * 3 * flops / PEAK_TF32
        t[key + " bound fma"] = bound_ms(n_bytes, 3 * flops, PEAK_FP32)
        units = (f"(z on the fp32 FMA units, dx and dW as three TF32 products each; on the "
                 f"FMA units alone {t[key + ' bound fma']:.4f} ms)")
    t[key + " bound"] = max(n_bytes / PEAK_BYTES, ops_s) * 1e3
    t[key + " bound by"] = "bytes" if n_bytes / PEAK_BYTES >= ops_s else "operations"
    return units


WIDE_OUT = 600             # a FullyFusedMLP output past M's and MB's layouts (at most 480)
WIDE_OUT_STEP_POW = 16     # its model's training steps
WIDE_OUT_STEPS = 10


def wide_output_checks(gen, dev, dtype, tag, t, err):
    """MW and MBW on a 128 -> ``WIDE_OUT`` last layer (B = 2^18, AoS input,
    the layout of the hidden activation at a run boundary; no activation, y
    in fp32, dx in fp32: the output layer as the model runs it) against
    their plain versions (y at the MLP bounds, dW and dx within 1e-4 or 2e-2
    of each largest magnitude, both bit for bit in a second launch), and
    their times beside the plain versions, their bounds and the cuBLAS
    products of the same work."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import (fused_mlp_bwd_plain, fused_mlp_plain,
                                                   fused_mlp_wide_bwd, fused_mlp_wide_fwd)

    B, none = MAIN_BATCH, Activation.NONE
    phase(f"slice 17: MW and MBW at a 128 -> {WIDE_OUT} last layer ({str(dtype)[6:]}) vs plain "
          f"at B={B}")
    (w,) = random_mlp(gen, dev, [(128, WIDE_OUT)])
    x = torch.rand((B, 128), generator=gen, device=dev).to(dtype)
    g = torch.randn((B, WIDE_OUT), generator=gen, device=dev)
    tol = "mlp-bf16" if dtype == torch.bfloat16 else "mlp-f32"
    f_args = (w, x, none, dtype, torch.float32, False, False)
    b_args = (w, x, g, none, dtype, False, False, torch.float32)
    with torch.inference_mode():
        y = fused_mlp_wide_fwd(*f_args)
        dw, dx = fused_mlp_wide_bwd(*b_args)
        dw2, dx2 = fused_mlp_wide_bwd(*b_args)
        torch.cuda.synchronize()
        check(torch.equal(dw, dw2) and torch.equal(dx, dx2),
              f"MBW {tag}: dW or dx differs between two launches")
        err[f"MW {tag}"] = compare(y, fused_mlp_plain([w], x, none, none, dtype, torch.float32,
                                                      False, False), tol)[0]
        want_dws, want_dx = fused_mlp_bwd_plain([w], x, g, none, none, dtype, False, False,
                                                torch.float32)
        err[f"MBW {tag}"] = compare_mlp_grads([dw, dx], [want_dws[0], want_dx], dtype,
                                              f"MBW {tag}")
        wc = w.to(dtype)
        t[f"MW {tag}"] = graph_ms(lambda: fused_mlp_wide_fwd(*f_args))
        t[f"MW {tag} plain"] = eager_ms(lambda: fused_mlp_plain([w], x, none, none, dtype,
                                                                torch.float32, False, False))
        t[f"MW {tag} library"] = graph_ms(lambda: (x @ wc).float())   # y in fp32: and a cast
        t[f"MBW {tag}"] = graph_ms(lambda: fused_mlp_wide_bwd(*b_args))
        t[f"MBW {tag} plain"] = eager_ms(lambda: fused_mlp_bwd_plain(
            [w], x, g, none, none, dtype, False, False, torch.float32))
        t[f"MBW {tag} library"] = graph_ms(lambda: library_bwd([wc], [x], g))
    print(f"{tag}: MW's max abs err {err[f'MW {tag}']:.3e}, MBW's {err[f'MBW {tag}']:.3e} (dW "
          "and dx; both bit for bit in a second launch)")
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    flops = 2 * B * w.numel()
    for k, n_bytes in ((f"MW {tag}", nbytes(x, wc, y)), (f"MBW {tag}", nbytes(x, wc, g, dx, dw))):
        if k.startswith("MW"):
            t[k + " bound"] = bound_ms(n_bytes, flops, peak)
            t[k + " bound by"] = bound_by(n_bytes, flops, peak)
            units = f"{flops / 1e9:.3f} GFLOP on the {UNIT[peak]}"
        else:
            units = f"{3 * flops / 1e9:.3f} GFLOP " + wide_bwd_bound(t, k, n_bytes, flops, dtype)
        print(f"{k}: {t[k]:.4f} ms on the device (plain {t[k + ' plain']:.4f} ms, cuBLAS "
              f"products {t[k + ' library']:.4f} ms, bound {t[k + ' bound']:.4f} ms: "
              f"{n_bytes / 1e6:.2f} MB, {units})")


def wide_output_config():
    """config_hash's grid into a FullyFusedMLP 128 x 2 (its outputs are the
    model's: ``WIDE_OUT``)."""
    import json
    import re

    cfg = json.loads(re.sub(r"//[^\n]*", "", open(CONFIG).read()))
    cfg["network"] = {**cfg["network"], "n_neurons": 128, "n_hidden_layers": 2}
    return cfg


def wide_output_slice(gen, dev):
    """Slice 17: FusedMLPs with outputs wider than kernels M's and MB's
    layouts, whose last layer runs alone through MW and MBW (redesigned on
    the tensor cores, any number of columns).  MW and MBW on a 128 -> 600
    layer in both dtypes against their plain versions, with their times
    (``wide_output_checks``); then config_hash's grid into a FullyFusedMLP
    128 x 2 with 600 outputs, in both policies: one step's gradients
    against the plain path and ``WIDE_OUT_STEPS`` training steps at
    2^``WIDE_OUT_STEP_POW`` on random targets (the loss falls), with their
    launches (MW runs the last layer's forward in fp32; in bf16 M's layout
    holds it).  Returns the report entries of MW and MBW at 600 columns."""
    from tcnn_tpu_torch import BF16_POLICY, Policy, create_from_config
    from tcnn_tpu_torch.ops.cuda.fused_mlp import m_plan, mb_plan

    t_phase = time.time()
    err, t, paths = {}, {}, {}
    for dtype, tag in ((torch.float32, f"{WIDE_OUT} fp32"), (torch.bfloat16, f"{WIDE_OUT} bf16")):
        wide_output_checks(gen, dev, dtype, tag, t, err)
    B = 1 << WIDE_OUT_STEP_POW
    for policy, tag in ((Policy(), f"{WIDE_OUT} fp32"), (BF16_POLICY, f"{WIDE_OUT} bf16")):
        cdt = policy.compute_dtype
        phase(f"slice 17: config_hash's grid into a FullyFusedMLP 128 x 2 -> {WIDE_OUT} "
              f"({str(cdt)[6:]}): a step's gradients vs the plain path, {WIDE_OUT_STEPS} "
              f"training steps at B={B} (the main path)")
        model = create_from_config(2, WIDE_OUT, wide_output_config(), policy=policy)
        net = model.network.network
        ws = [w.detach().to(cdt) for w in net.layers]
        # the last layer fits MB's layout in neither dtype, M's in bf16 only
        fp32 = cdt == torch.float32
        runs = (m_plan(ws, cdt, True), mb_plan(ws, cdt, net.activation, net.output_activation))
        check(runs == ([(0, 2), (2, 3)] if fp32 else [(0, 3)], [(0, 2), (2, 3)]),
              f"{tag} model: expected its last layer alone in MB's runs (and in M's in fp32), "
              f"got {runs}")
        x = torch.rand((B, 2), generator=gen, device=dev)
        target = torch.rand((B, WIDE_OUT), generator=gen, device=dev)
        check_step_gradients(model, x, target, flips=cdt == torch.bfloat16)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        losses = [model.trainer.training_step(x, target) for _ in range(WIDE_OUT_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.time() - t0) / WIDE_OUT_STEPS * 1e3
        launches = counts()
        losses = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(losses).all()), f"{tag} model: non-finite loss")
        print(f"{tag} model: loss {float(losses[0]):.6f} -> {float(losses[-1]):.6f} in "
              f"{WIDE_OUT_STEPS} steps, {step_ms:.3f} ms a step eager (host clock); "
              f"launches {launches}")
        check(float(losses[-1]) < float(losses[0]), f"{tag} model: the loss did not fall")
        n = WIDE_OUT_STEPS
        want = {"G": n, "M": 2 * n, "GB": n, "MB": n, "GI": 0, "GG": 0, "RS": 0, "GT": 0,
                "MW": n if fp32 else 0, "MBW": n}
        check(launches == want, f"{tag} model launches {launches}: expected per step G, GB, M "
              "twice (the forward's run and the backward's boundary), MBW and MB once, and MW "
              "once in fp32")
        paths[tag] = launches
    check(all(sum(c[k] for c in paths.values()) >= 1 for k in ("MW", "MBW")),
          f"slice 17: MW or MBW was not launched on the main path: {paths}")
    out = []
    for tag, launches in paths.items():
        path = (f"{WIDE_OUT_STEPS} training steps of config_hash's grid into a FullyFusedMLP "
                f"128 x 2 -> {WIDE_OUT} ({tag.split()[1]})")
        for k, r in (("MW", REPLACES_M), ("MBW", REPLACES_MB)):
            note = path if launches[k] else (f"checked against plain and timed only: M's layout "
                                             f"holds the last layer there; {path} launches no {k}")
            out += entries(t, [(f"{k} {tag}", k, r)], launches, err,
                           {"path": note, "batch": MAIN_BATCH})
    print(f"slice 17: the phase took {time.time() - t_phase:.1f} s")
    return out


def top_device(prof, top):
    """A finished ``profiling.trace``'s ``top`` CUDA kernels by device time,
    as (name, ms, calls)."""
    from torch.autograd import DeviceType

    def us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    ev = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA), key=us,
                reverse=True)
    return [(e.key, us(e) / 1e3, e.count) for e in ev[:top]]


def wide_features_slice(gen, dev):
    """Slice 16: grids of more than 8 features a level and FusedMLPs with
    wide inputs, which the card once refused.  G, GB, GI, GG and GT at
    F = 16 (the wide SDF's grid, fp32) and F = 32 (the wide image's, bf16
    table) against their plain versions, and their times; M and MB at 256
    (fp32) and 512 (bf16) inputs with their streamed-layer instances; the
    wide SDF (2^19-row tables, 256 MLP inputs, fp32) through its eikonal
    step and curvature step (ReLU, on points clear of a switch, and
    Softplus) at 2^18 against the plain path, with
    their launches, device times and split, and a 200-step eikonal fit at
    2^14 with a floor
    from the JAX package's run of the same fit; the wide image (config_hash's
    geometry at 32 features, 512 MLP inputs, BF16_POLICY) through one
    step's gradients against the plain path and 100 steps of
    ``make_training_loop`` at 2^18 (the loss falls more than 10x).
    Returns the report entries of the new instances."""
    from tcnn_tpu_torch import BF16_POLICY, Policy, create_from_config
    from tcnn_tpu_torch.ops.cuda.fused_mlp import m_plan, mb_plan
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
    from tcnn_tpu_torch.utils import profiling
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image

    t_phase = time.time()
    err, t = {}, {}
    sdf_model = create_from_config(3, 1, wide_sdf_config(WIDE_ROWS_POW), policy=Policy())
    img_model = create_from_config(2, 3, wide_image_config(), policy=BF16_POLICY)
    grids = (("F=16", sdf_model.network.encoding.spec, torch.float32),
             ("F=32", img_model.network.encoding.spec, torch.bfloat16))
    for tag, spec, dtype in grids:
        D, F = spec.n_dims, spec.n_features_per_level
        B = 1 << WIDE_KERNEL_POW
        phase(f"slice 16: a {D}-D grid of {spec.n_levels} levels x {F} features "
              f"({spec.n_params} parameters, {str(dtype)[6:]} table): G, GB, GI, GG and GT "
              f"vs plain at B={B}")
        live = list(range(spec.n_levels))
        table = (torch.rand(spec.n_params, generator=gen, device=dev) * 2 - 1).to(dtype)
        x = torch.rand((B, D), generator=gen, device=dev) * 0.9 + 0.05
        dcols = torch.randn((spec.n_output_dims, B), generator=gen, device=dev).to(dtype)
        ddx, beta = (torch.randn((B, D), generator=gen, device=dev) for _ in range(2))
        e = grid_kernel_checks(spec, table, x, dcols, ddx, label=f"{D}-D {tag}")
        err.update({f"{k} {tag}": e[k] for k in ("G", "GB", "GI", "GG")})
        err[f"GT {tag}"] = max(check_third_order(spec, table, x, dcols, ddx, beta, live,
                                                 label=f"{D}-D {tag}").values())
        Bt = MAIN_BATCH
        phase(f"slice 16: the {tag} grid kernels' times at B={Bt}")
        xt = torch.rand((Bt, D), generator=gen, device=dev) * 0.9 + 0.05
        dct = torch.randn((spec.n_output_dims, Bt), generator=gen, device=dev).to(dtype)
        ddt, bet = (torch.randn((Bt, D), generator=gen, device=dev) for _ in range(2))
        time_grid_kernels(spec, table, xt, dct, ddt, t, {f"{k} {tag}": k for k in
                                                         ("G", "GB", "GI", "GG")},
                          plain_calls=2)
        gt_time(spec, table, xt, dct, ddt, bet, t, f"GT {tag}")
    phase("slice 16: the widest MLP input and output one launch of M and MB takes")
    mlp_width_limits()
    wide_mlp_checks(gen, dev, 256, 1, torch.float32, "256 fp32", t, err)
    wide_mlp_checks(gen, dev, 512, 3, torch.bfloat16, "512 bf16", t, err)

    net = sdf_model.network
    mlp = [w.detach() for w in net.network.layers]
    n_fwd = len(m_plan(mlp, torch.float32, True))
    check(m_plan(mlp, torch.float32, True) == [(0, 1), (1, 3)]
          and mb_plan(mlp, torch.float32, net.network.activation,
                      net.network.output_activation) == [(0, 3)],
          "wide SDF: expected M's runs [(0, 1), (1, 3)] and MB's [(0, 3)]")
    Bs = 1 << WIDE_STEP_POW
    phase(f"slice 16: the wide SDF's eikonal step at B={Bs} vs the plain eikonal step "
          "(the main path)")
    xs, xv = sdf.sample_points(gen, Bs, dev)
    # two forwards a step, each a streamed first layer and M over the rest;
    # MB once for each (one launch: 256 inputs fit its fp32 layout)
    eik = check_eikonal_step(net, xs, xv, None, "wide SDF eikonal step", expect={
        "G": 2, "M": 2 * (n_fwd - 1), "MB": 2, "GB": 1, "GI": 1, "GG": 1, "RS": 0, "GT": 0,
        "MW": 2, "MBW": 0}, table_rel=1e-4)
    # ReLU (the sample's activation): a pre-activation within fp32 rounding
    # of 0 may switch between the two paths, and in the curvature term such
    # samples moved a table entry by 0.604, 2.6 % of the largest (on an
    # H100): held on points drawn clear of the switches, first printed as
    # drawn; then Softplus, which has no switch, on points as drawn
    phase(f"slice 16: the wide SDF's curvature step (ReLU) at B={Bs} vs the plain path, "
          f"on points clear of a ReLU switch by {WIDE_RELU_NEAR:.3g}·Σ|h·w|")
    curv_relu = curvature_check(gen, dev, "ReLU", net=net, n_pow=WIDE_STEP_POW,
                                kernels=("MW",), near=WIDE_RELU_NEAR)
    phase(f"slice 16: the wide SDF's curvature step (Softplus) at B={Bs} vs the plain path")
    cfg = wide_sdf_config(WIDE_ROWS_POW)
    soft = create_from_config(3, 1, {**cfg, "network": {**cfg["network"],
                                                        "activation": "Softplus"}},
                              policy=Policy()).network
    curv = curvature_check(gen, dev, "Softplus", net=soft, n_pow=WIDE_STEP_POW,
                           kernels=("MW",))
    del soft

    phase(f"slice 16: the wide SDF's steps at B={Bs}: eager, on the device, and split")
    opt = sdf_model.optimizer
    v = sdf.sample_directions(gen, Bs, dev)
    state = opt.init(dict(net.named_parameters()), net.param_layout())

    def eikonal_step():
        sdf.step(net, opt, state, xs, xv)

    def curvature_step():
        _, gr = sdf.curvature_loss_and_grads(net, xs, xv, v)
        opt.step(state, gr, dict(net.named_parameters()))

    for name, fn in (("eikonal", eikonal_step), ("curvature", curvature_step)):
        t[f"wide {name} step"] = time_ms(fn, n=5)
        t[f"wide {name} step device"] = graph_ms(fn, n=5)
        fn()
        torch.cuda.synchronize()
        with profiling.trace() as prof:
            fn()
        split = profiling.split(prof)
        print(f"wide SDF {name} step at B={Bs}: {t[f'wide {name} step']:.4f} ms eager with "
              f"the host's work, {t[f'wide {name} step device']:.4f} ms of device work "
              f"(idle share {1 - t[f'wide {name} step device'] / t[f'wide {name} step']:.3f});"
              f" under the profiler, CUDA kernels {split['device_ms']:.4f} ms "
              f"({'not measured: no device activity recorded' if not split['device_ms'] else 'CUPTI'})")
        for kname, ms, n in top_device(prof, 8):
            print(f"  device time: {kname[:90]} {ms:.4f} ms in {n} calls")

    phase(f"slice 16: the wide SDF's fit, {WIDE_FIT_STEPS} steps at 2^{WIDE_FIT_POW} on "
          f"2^{WIDE_FIT_ROWS_POW}-row tables through create_from_config (the main path)")
    torch.cuda.synchronize()
    reset_counts()
    fit = sdf.main(["fit_sdf_eikonal", str(WIDE_FIT_STEPS), str(WIDE_FIT_POW)],
                   config=wide_sdf_config(WIDE_FIT_ROWS_POW))
    torch.cuda.synchronize()
    fit_launches = counts()
    losses = fit["losses"]
    check(bool(torch.isfinite(losses).all()), "non-finite wide SDF fit loss")
    first, last10 = float(losses[0]), float(losses[-10:].mean())
    print(f"wide SDF fit: loss {first:.6f} -> {last10:.6f} (mean of the last 10; JAX "
          f"{WIDE_FIT_LOSS_JAX}, floor {WIDE_FIT_LOSS_FLOOR}); sdf error "
          f"{fit['sdf_error']:.4f}; {fit['seconds']:.2f} s; launches {fit_launches}")
    check(last10 < WIDE_FIT_LOSS_FLOOR,
          f"wide SDF loss floor missed: {last10} >= {WIDE_FIT_LOSS_FLOOR}")
    # the eager warm-up step and the capture, the other steps replayed; MW
    # once more for the evaluation
    check(fit_launches["MW"] == 2 * 2 + 1 and fit_launches["GG"] == 2,
          f"wide SDF fit launches {fit_launches}")

    phase(f"slice 16: the wide image (BF16_POLICY): one step's gradients vs the plain path "
          f"at B={MAIN_BATCH}, then {WIDE_IMAGE_STEPS} steps of make_training_loop")
    x = torch.rand((MAIN_BATCH, 2), generator=gen, device=dev)
    target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
    check_step_gradients(img_model, x, target, flips=True)
    imlp = [w.detach().to(torch.bfloat16) for w in img_model.network.network.layers]
    check(m_plan(imlp, torch.bfloat16, True) == [(0, 3)]
          and len(mb_plan(imlp, torch.bfloat16, img_model.network.network.activation,
                          img_model.network.network.output_activation)) == 2,
          "wide image: expected M in one launch and MB in two runs")
    sampler = ImageSampler(synthetic_image(1024, 1024), seed=0)
    loop = img_model.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH),
                                                WIDE_IMAGE_STEPS)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    losses = loop()
    torch.cuda.synchronize()
    loop_s = time.time() - t0
    img_launches = counts()   # the loop's eager warm-up step and its capture
    losses = losses.cpu()
    check(bool(torch.isfinite(losses).all()), "non-finite wide image loss")
    first, last10 = float(losses[0]), float(losses[-10:].mean())
    print(f"wide image: {WIDE_IMAGE_STEPS} steps in {loop_s:.2f} s (capture included); loss "
          f"{first:.5f} -> {last10:.5f} (mean of the last 10), {first / last10:.1f}x; launches "
          f"{img_launches}")
    check(first > 10 * last10, f"wide image loss fell {first / last10:.2f}x, not 10x")
    check(img_launches == {"G": 2, "M": 2, "GB": 2, "MB": 2, "GI": 0, "GG": 0, "RS": 0,
                           "GT": 0, "MW": 2, "MBW": 2},
          f"wide image loop launches {img_launches}: expected per step G, M, GB and MB, "
          "MB's first run alone (MBW) and M's streamed layer at its boundary (MW)")
    t["wide image loop step"] = loop_s / WIDE_IMAGE_STEPS * 1e3

    # each entry's launches are its own model's main path: the wide SDF's
    # steps and fit for F = 16 and 256 fp32 inputs, the wide image's loop
    # for F = 32 and 512 bf16 inputs; 0 where that path launches no such
    # kernel (checked against plain above, and timed, only)
    sdf_path = {k: eik[k] + curv_relu[k] + curv[k] + fit_launches[k] for k in fit_launches}
    paths = {"wide SDF": (sdf_path, "the wide SDF's eikonal and curvature steps and its fit"),
             "wide image": (img_launches, "the wide image's make_training_loop")}
    out = []
    for tag, model, extra, ks in (
            ("F=16", "wide SDF", {"grid": "wide SDF, 3-D, 16 x 16, fp32 table"},
             (("G", REPLACES_G), ("GB", REPLACES_GB), ("GI", REPLACES_GI),
              ("GG", REPLACES_GG), ("GT", REPLACES_GT))),
            ("F=32", "wide image", {"grid": "wide image, 2-D, 16 x 32, bf16 table"},
             (("G", REPLACES_G), ("GB", REPLACES_GB), ("GI", REPLACES_GI),
              ("GG", REPLACES_GG), ("GT", REPLACES_GT))),
            ("256 fp32", "wide SDF", {}, (("M", REPLACES_M), ("MB", REPLACES_MB),
                                          ("MW", REPLACES_M), ("MBW", REPLACES_MB))),
            ("512 bf16", "wide image", {}, (("M", REPLACES_M), ("MB", REPLACES_MB),
                                            ("MW", REPLACES_M), ("MBW", REPLACES_MB)))):
        launches, path = paths[model]
        for k, r in ks:
            note = path if launches[k] else (f"checked against plain and timed only: "
                                             f"{path} launches no {k}")
            out += entries(t, [(f"{k} {tag}", k, r)], launches, err,
                           {**extra, "path": note, "batch": MAIN_BATCH})
    want_sdf = ("G", "GB", "GI", "GG", "GT", "M", "MB", "MW")
    want_img = ("G", "GB", "M", "MB", "MW", "MBW")
    check(all(sdf_path[k] > 0 for k in want_sdf) and all(img_launches[k] > 0 for k in want_img),
          f"slice 16: a kernel of a main path was not launched: wide SDF {sdf_path}, "
          f"wide image {img_launches}")
    print(f"slice 16: wide SDF eikonal step launches {eik}, curvature steps {curv_relu} "
          f"(ReLU) and {curv} (Softplus), its path {sdf_path}; wide image loop "
          f"{img_launches}; the phase took {time.time() - t_phase:.1f} s")
    return out


def mb_determinism(gen, dev):
    """Kernel MB twice on the same inputs at the SDF shape (16 -> 64 x 2 ->
    1, SoA input) and at config_btf's (40 -> 64 x 3 -> 3, AoS), B = 2^18,
    in both compute dtypes: dW and dx must be equal bit for bit (each dW
    element has one owner thread, every sum a fixed order)."""
    from tcnn_tpu_torch.common import Activation
    from tcnn_tpu_torch.ops.cuda.fused_mlp import fused_mlp_bwd

    phase(f"MB determinism: two launches at B={MAIN_BATCH}, dW compared bit for bit")
    for label, dims, soa in (("sdf", mlp_dims(16, 64, 2, d_out=1), True),
                             ("config_btf", mlp_dims(40, 64, 3), False)):
        ws = random_mlp(gen, dev, dims)
        x = torch.rand((dims[0][0], MAIN_BATCH) if soa else (MAIN_BATCH, dims[0][0]),
                       generator=gen, device=dev) * 2 - 1
        g = torch.randn((MAIN_BATCH, dims[-1][1]), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            args = (ws, x.to(dtype), g, Activation.RELU, Activation.NONE, dtype, soa, False)
            with torch.inference_mode():
                first_dws, first_dx = fused_mlp_bwd(*args)
                again_dws, again_dx = fused_mlp_bwd(*args)
                torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(first_dws, again_dws)]
            check(all(same) and torch.equal(first_dx, again_dx),
                  f"MB determinism {label} {dtype}: dW layers equal {same}, dx equal "
                  f"{torch.equal(first_dx, again_dx)}")
            print(f"MB determinism: {label} {str(dtype)[6:]}: {len(same)} dW layers and dx "
                  f"bit-identical across two launches")


# Slice 19: the deterministic table gradient, TCNN_TPU_SCATTER=sortseg
# (ops/sort_scatter.py; kernels SK and SS, csrc/sort_scatter.cu).
SORTSEG_STEPS = FIT_STEPS       # the main path: 200 steps at 2^18, twice from one seed
SORTSEG_REPLAY_STEPS = 20       # the captured loop against the same steps taken eagerly
SORTSEG_DP_STEPS = 20           # DataParallel's loop on a one-rank NCCL group
REPLACES_SORTSEG = ("none (XLA ops): tcnn_tpu/ops/sort_scatter.py:23 (sort_segment_scatter: "
                    "jnp.argsort, cumsum, one scatter), the TCNN_TPU_SCATTER=sortseg branch of "
                    "tcnn_tpu/ops/grid_ops.py:962-977")
KERNELS["SK"] = ("sort_keys", "tcnn_tpu_torch/csrc/sort_scatter.cu")
KERNELS["SS"] = ("segment_sum", "tcnn_tpu_torch/csrc/sort_scatter.cu")


def sortseg_counters():
    from tcnn_tpu_torch.ops.cuda.sort_scatter import segment_sum, sort_keys

    return {"SK": sort_keys, "SS": segment_sum}


def all_counts():
    return {**counts(), **{k: fn.launches for k, fn in (*sortseg_counters().items(),
                                                          *shampoo_counters().items())}}


def set_sortseg(on):
    """Selects the route (read at each backward, fixed in a captured step)."""
    if on:
        os.environ["TCNN_TPU_SCATTER"] = "sortseg"
    else:
        os.environ.pop("TCNN_TPU_SCATTER", None)


def peak_mb(fn):
    """MB allocated by ``fn()`` above what was allocated before it, at its peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def ss_bound(keys, vals, n_rows):
    """SS against its plain version, per row: 2^-23·(P + n·A), P the largest
    |float64 prefix sum| of the row's column over the sorted values, n the
    row's run length, A the sum of its values' magnitudes
    (``ops/cuda/sort_scatter.py``)."""
    order = torch.sort(keys, stable=True).indices
    p = torch.stack([vals[order, k].double().cumsum(0).abs().max()
                     for k in range(vals.shape[1])])
    keep = (keys >= 0) & (keys < n_rows)
    a = torch.zeros((n_rows, vals.shape[1]), dtype=torch.float64, device=vals.device)
    a.index_add_(0, keys[keep].long(), vals[keep].double().abs())
    n = torch.bincount(keys[keep].long(), minlength=n_rows)[:, None].double()
    return 2.0 ** -23 * (p[None, :] + n * a)


def sk_flops(spec, batch):
    """SK per (sample, level): positions and per-dim weights (4D), corner
    weights C(D − 1), the products w·dy (CF); the rows' integer work aside."""
    D, C = spec.n_dims, 1 << spec.n_dims
    return batch * spec.n_levels * (4 * D + C * (D - 1) + C * spec.n_features_per_level)


def sortseg_kernel_checks(label, spec, table, xg, dcols, gen, t, err):
    """Kernels SK and SS and the route at one shape (the grid's inputs as
    the main path hands them): SK against its plain version bit for bit, SS
    against its plain version within ``ss_bound``, bit for bit twice and on
    small-integer values (every sum exact), the route against GB's plain
    version (``compare_table_grad``) and bit for bit twice, GB twice
    (entries that differ: a number, not a gate), the deterministic
    ``index_add_`` bit for bit twice; times, bounds, SS's gather floor, the
    library calls (``index_add_``, and under
    ``torch.use_deterministic_algorithms(True)`` the yardstick of the sort
    and SS together) and peak memory into ``t``."""
    from tcnn_tpu_torch.ops.cuda.grid_encode import grid_encode_bwd, grid_encode_bwd_plain
    from tcnn_tpu_torch.ops.cuda.sort_scatter import (segment_sum, segment_sum_plain,
                                                      sort_keys, sort_keys_plain)
    from tcnn_tpu_torch.ops.sort_scatter import grid_table_gradient
    from tcnn_tpu_torch.tools.kernel_ablation import gather_floor_bytes, index_add_deterministic

    B, F, C = xg.shape[0], spec.n_features_per_level, 1 << spec.n_dims
    live, n_rows = list(range(spec.n_levels)), spec.n_entries
    phase(f"slice 19: SK, SS and the sortseg route vs plain, {label} (B={B}, {len(live)} levels, "
          f"{C} corners, F={F}: {len(live) * C * B} updates), table {str(table.dtype)[6:]}")
    with torch.inference_mode():
        keys, vals = sort_keys(spec, xg, dcols, live)
        torch.cuda.synchronize()
        want_keys, want_vals = sort_keys_plain(spec, xg, dcols, live)
        check(torch.equal(keys, want_keys) and torch.equal(vals, want_vals),
              f"{label}: SK's keys or values differ from its plain version")
        del want_keys, want_vals
        sk, order = torch.sort(keys, stable=True)
        got = segment_sum(sk, order, vals, n_rows)
        again = segment_sum(sk, order, vals, n_rows)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{label}: SS differs between two launches")
        d = (got - segment_sum_plain(sk, order, vals, n_rows)).abs()
        bound = ss_bound(keys, vals, n_rows)
        check(bool((d.double() <= bound).all()),
              f"{label}: SS beyond 2^-23·(P + n·A) of its plain version, max abs err "
              f"{d.max().item():.3e}")
        err[f"SS {label}"] = d.max().item()
        err[f"SK {label}"] = 0.0
        ints = torch.randint(-2, 3, vals.shape, generator=gen, device=vals.device).float()
        check(torch.equal(segment_sum(sk, order, ints, n_rows, table.dtype),
                          segment_sum_plain(sk, order, ints, n_rows, table.dtype)),
              f"{label}: SS on small integers (exact sums) differs from its plain version")
        print(f"{label}: SK equal to its plain version bit for bit ({keys.numel()} keys and "
              f"values); SS bit-identical in two launches, max abs err {err[f'SS {label}']:.3e} "
              f"(bound 2^-23·(P + n·A), its largest {bound.max().item():.3e}), equal on "
              f"small-integer values")
        del d, bound, ints, again
        route = grid_table_gradient(spec, table, xg, dcols, live)
        check(torch.equal(route, grid_table_gradient(spec, table, xg, dcols, live)),
              f"{label}: the route differs between two calls")
        want = grid_encode_bwd_plain(spec, table, xg, dcols, live)
        scale = grid_encode_bwd_plain(spec, table.float(), xg, dcols.float().abs(), live)
        route_err = compare_table_grad(route, want, scale, f"{label} sortseg route")
        gb_a = grid_encode_bwd(spec, table, xg, dcols, live)
        gb_b = grid_encode_bwd(spec, table, xg, dcols, live)
        t[f"GB twice {label}"] = int((gb_a != gb_b).sum())
        print(f"{label}: the route against GB's plain version, max abs err {route_err:.3e} "
              f"(2^-11·S{' + one bf16 ulp' if table.dtype == torch.bfloat16 else ''}), "
              f"bit-identical in two calls; GB launched twice on the same inputs differs in "
              f"{t[f'GB twice {label}']} of {gb_a.numel()} entries")
        del route, want, scale, gb_a, gb_b

    phase(f"slice 19: times at {label}, device time in a CUDA graph of {N_TIMED} calls; "
          f"plain versions eager")
    with torch.inference_mode():
        t[f"SK {label}"] = graph_ms(lambda: sort_keys(spec, xg, dcols, live))
        t[f"SK {label} plain"] = eager_ms(lambda: sort_keys_plain(spec, xg, dcols, live), n=3)
        t[f"sort {label}"] = graph_ms(lambda: torch.sort(keys, stable=True))
        t[f"SS {label}"] = graph_ms(lambda: segment_sum(sk, order, vals, n_rows, table.dtype))
        t[f"SS {label} plain"] = eager_ms(
            lambda: segment_sum_plain(sk, order, vals, n_rows, table.dtype), n=3)
        t[f"SS {label} library"] = graph_ms(
            lambda: torch.zeros((n_rows, F), device=vals.device).index_add_(0, keys, vals))
        # the route after SK (the sort and SS) as one PyTorch call: index_add_
        # under torch.use_deterministic_algorithms(True)
        det_a = index_add_deterministic(keys, vals, n_rows)
        det_b = index_add_deterministic(keys, vals, n_rows)
        torch.cuda.synchronize()
        check(torch.equal(det_a.view(torch.int32), det_b.view(torch.int32)),
              f"{label}: the deterministic index_add_ differs between two calls")
        t[f"SS {label} deterministic library"] = graph_ms(
            lambda: index_add_deterministic(keys, vals, n_rows))
        del det_a, det_b
        t[f"route {label}"] = graph_ms(lambda: grid_table_gradient(spec, table, xg, dcols, live))
        t[f"GB {label}"] = graph_ms(lambda: grid_encode_bwd(spec, table, xg, dcols, live))
        t[f"route {label} MB"] = peak_mb(lambda: grid_table_gradient(spec, table, xg, dcols,
                                                                     live))
        t[f"GB {label} MB"] = peak_mb(lambda: grid_encode_bwd(spec, table, xg, dcols, live))
    m = keys.numel()
    b = {f"SK {label}": (B * spec.n_dims * 4 + nbytes(dcols) + nbytes(keys, vals),
                         sk_flops(spec, B), PEAK_FP32),
         f"SS {label}": (nbytes(keys, order, vals) + n_rows * F * table.element_size(),
                         m * F, PEAK_FP32)}
    for k, (n_bytes, flops, peak) in b.items():
        t[k + " bound"] = bound_ms(n_bytes, flops, peak)
        t[k + " bound by"] = bound_by(n_bytes, flops, peak)
    floor = gather_floor_bytes(keys, order, vals, table.element_size(), n_rows)
    t[f"SS {label} gather floor"] = bound_ms(floor, 0, PEAK_FP32)
    print(f"{label}: SK {t[f'SK {label}']:.4f} ms (plain {t[f'SK {label} plain']:.4f}, bound "
          f"{t[f'SK {label} bound']:.4f}: {b[f'SK {label}'][0] / 1e6:.1f} MB); torch.sort "
          f"{t[f'sort {label}']:.4f} ms; SS {t[f'SS {label}']:.4f} ms (plain "
          f"{t[f'SS {label} plain']:.4f}, index_add_ {t[f'SS {label} library']:.4f}, bound "
          f"{t[f'SS {label} bound']:.4f}: {b[f'SS {label}'][0] / 1e6:.1f} MB; the gather's "
          f"sector floor {t[f'SS {label} gather floor']:.4f}: {floor / 1e6:.1f} MB); the "
          f"deterministic index_add_ (the sort and SS as one call, bit-identical twice, in "
          f"a CUDA graph) {t[f'SS {label} deterministic library']:.4f} ms; the route "
          f"{t[f'route {label}']:.4f} ms against GB's {t[f'GB {label}']:.4f} (the sort "
          f"{t[f'sort {label}'] / t[f'route {label}']:.3f} of the route); peak memory of the "
          f"route {t[f'route {label} MB']:.1f} MB, of GB {t[f'GB {label} MB']:.1f} MB")


def sortseg_fit(image, steps, sortseg):
    """config_hash (BF16_POLICY) from its seed, ``steps`` steps at B =
    MAIN_BATCH of ``make_training_loop`` on the seeded image sampler, the
    launch counts set to 0 just before and read just after; returns
    (losses, the trained weights, the launches, the model, the sampler)."""
    from tcnn_tpu_torch import BF16_POLICY, create_from_config
    from tcnn_tpu_torch.utils.image import ImageSampler

    set_sortseg(sortseg)
    try:
        fit = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
        sampler = ImageSampler(image, seed=0)
        loop = fit.trainer.make_training_loop(lambda i: sampler.sample_batch(MAIN_BATCH), steps)
        torch.cuda.synchronize()
        reset_counts()
        losses = loop()
        torch.cuda.synchronize()
        launches = all_counts()
    finally:
        set_sortseg(False)
    return losses.cpu(), [p.detach().clone() for p in fit.trainer.params().values()], \
        launches, fit, sampler


def sortseg_slice(gen, dev):
    """Slice 19, the deterministic table gradient (``TCNN_TPU_SCATTER=sortseg``,
    ``ops/sort_scatter.py``): kernels SK and SS and the route at config_hash's
    and config_btf's grids (2^18, bf16 tables and dcols as the main paths
    hand them; ``sortseg_kernel_checks``); the main path, config_hash at full
    width trained through ``make_training_loop`` under ``sortseg`` twice from
    one seed (200 steps at 2^18): every weight and loss bit-identical, SK and
    SS launched and GB not, the loss falling and a PSNR floor; the same fit
    with GB twice (weights that differ: a number, not a gate); the captured
    loop against the same steps taken eagerly, bit for bit; the step on the
    device under each route at config_hash and config_btf, with its peak
    memory; ``DataParallel.make_training_loop`` on a one-rank NCCL group
    under ``sortseg`` (its capture takes the sort; SK and SS in the warm-up
    and each replay; losses and weights equal to the trainer loop's, bit
    for bit).  Returns the report entries of SK and SS."""
    import tempfile

    from tcnn_tpu_torch import BF16_POLICY, create_from_config
    from tcnn_tpu_torch.tools import parallel_check
    from tcnn_tpu_torch.tools.plain_path import grid_parts
    from tcnn_tpu_torch.utils.image import synthetic_image
    from tcnn_tpu_torch.utils.metrics import psnr

    t_phase = time.time()
    t, err, models = {}, {}, {}
    for label, n_in, cfg in (("config_hash", 2, CONFIG), ("config_btf", 6, BTF_CONFIG)):
        model = create_from_config(n_in, 3, cfg, policy=BF16_POLICY)
        models[label] = model
        x = torch.rand((MAIN_BATCH, n_in), generator=gen, device=dev)
        (_, grid, xg, _), = grid_parts(model, x)
        with torch.no_grad():
            grid.grid.uniform_(-1, 1, generator=gen)
        spec = grid.spec
        dcols = torch.randn((spec.n_output_dims, MAIN_BATCH), generator=gen,
                            device=dev).to(torch.bfloat16)
        if label == "config_btf":   # the transpose of MB's AoS input gradient, read in place
            dcols = dcols.t().contiguous().t()
        sortseg_kernel_checks(label, spec, grid.grid.detach().to(torch.bfloat16), xg, dcols,
                              gen, t, err)

    phase(f"slice 19: the main path, config_hash (BF16_POLICY) through make_training_loop "
          f"under TCNN_TPU_SCATTER=sortseg, {SORTSEG_STEPS} steps at B={MAIN_BATCH}, twice "
          f"from one seed")
    image = synthetic_image(1024, 1024)
    losses, weights, launches, fit, sampler = sortseg_fit(image, SORTSEG_STEPS, True)
    losses2, weights2, launches2, _, _ = sortseg_fit(image, SORTSEG_STEPS, True)
    check(launches["SK"] >= 1 and launches["SS"] >= 1 and launches["GB"] == 0,
          f"the sortseg fit's launches {launches}: expected SK and SS, and no GB")
    check(launches == launches2, f"the two sortseg fits launched {launches} and {launches2}")
    same = [torch.equal(a, b) for a, b in zip(weights, weights2)]
    check(all(same) and torch.equal(losses, losses2),
          f"two sortseg fits from one seed: weights equal {same}, losses equal "
          f"{torch.equal(losses, losses2)}")
    check(bool(torch.isfinite(losses).all()), "the sortseg fit: non-finite loss")
    first, last10 = float(losses[0]), float(losses[-10:].mean())
    fit_psnr = psnr(fit.trainer.inference(sampler.full_grid_coords()),
                    sampler.image.reshape(-1, 3))
    check(last10 < 0.2 * first and fit_psnr > 20.0,
          f"the sortseg fit: loss {first} -> {last10}, PSNR {fit_psnr:.2f} dB")
    print(f"two sortseg fits: every weight ({sum(w.numel() for w in weights)} values) and "
          f"every loss bit-identical; loss {first:.4f} -> {last10:.4f} (mean of the last "
          f"10); PSNR {fit_psnr:.2f} dB; launches {launches} (the warm-up step and the "
          f"captured one)")
    _, gb_weights, gb_launches, _, _ = sortseg_fit(image, SORTSEG_STEPS, False)
    _, gb_weights2, _, _, _ = sortseg_fit(image, SORTSEG_STEPS, False)
    check(gb_launches["GB"] >= 1 and gb_launches["SK"] == gb_launches["SS"] == 0,
          f"the GB fit's launches {gb_launches}")
    gb_diff = [int((a != b).sum()) for a, b in zip(gb_weights, gb_weights2)]
    t["GB fit diff"] = gb_diff
    print(f"two GB fits from one seed (the same {SORTSEG_STEPS} steps without sortseg): "
          f"{sum(gb_diff)} of {sum(w.numel() for w in gb_weights)} weights differ, per "
          f"parameter {gb_diff} (a number, not a gate)")

    phase(f"slice 19: the captured loop against the same {SORTSEG_REPLAY_STEPS} steps taken "
          f"eagerly, under sortseg")
    from tcnn_tpu_torch.utils.image import ImageSampler

    set_sortseg(True)
    try:
        runs = []
        for captured in (True, False):
            model = create_from_config(2, 3, CONFIG, policy=BF16_POLICY)
            smp = ImageSampler(image, seed=1)
            if captured:
                ls = model.trainer.make_training_loop(lambda i: smp.sample_batch(MAIN_BATCH),
                                                      SORTSEG_REPLAY_STEPS)()
            else:
                ls = torch.stack([model.trainer.training_step(*smp.sample_batch(MAIN_BATCH))
                                  for _ in range(SORTSEG_REPLAY_STEPS)])
            torch.cuda.synchronize()
            runs.append((ls.cpu(), [p.detach().clone() for p in model.trainer.params().values()]))
    finally:
        set_sortseg(False)
    same = [torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])]
    check(all(same) and torch.equal(runs[0][0], runs[1][0]),
          f"the captured loop against eager steps: weights equal {same}, losses equal "
          f"{torch.equal(runs[0][0], runs[1][0])}")
    print(f"the captured loop's {SORTSEG_REPLAY_STEPS} steps equal the eager steps bit for bit "
          f"(losses and every weight)")

    phase(f"slice 19: the training step on the device (a CUDA graph of {N_TIMED} steps) under "
          f"each route, and its peak memory, B={MAIN_BATCH}")
    for label, model in models.items():
        n_in = 2 if label == "config_hash" else 6
        x = torch.rand((MAIN_BATCH, n_in), generator=gen, device=dev)
        target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
        trainer = model.trainer
        for route in ("GB", "sortseg"):
            set_sortseg(route == "sortseg")
            try:
                t[f"step {label} {route}"] = graph_ms(lambda: trainer.training_step(x, target))
                t[f"step {label} {route} MB"] = peak_mb(lambda: trainer.training_step(x, target))
            finally:
                set_sortseg(False)
        print(f"{label}: the step {t[f'step {label} GB']:.4f} ms on the device with GB, "
              f"{t[f'step {label} sortseg']:.4f} with the sortseg route "
              f"(+{t[f'step {label} sortseg'] - t[f'step {label} GB']:.4f} ms); its peak "
              f"memory {t[f'step {label} GB MB']:.1f} MB and "
              f"{t[f'step {label} sortseg MB']:.1f} MB")

    phase(f"slice 19: DataParallel.make_training_loop under sortseg on a one-rank NCCL group, "
          f"config_hash, {SORTSEG_DP_STEPS} steps at B={MAIN_BATCH}")
    with tempfile.TemporaryDirectory() as tmp:
        res, = parallel_check.run_ranks(1, parallel_check.nccl_sortseg_job,
                                        {"steps": SORTSEG_DP_STEPS, "batch": MAIN_BATCH},
                                        timeout=600, tmp=tmp, backend="nccl")
    check(res["backend"] == "nccl", f"the group's backend is {res['backend']}")
    for what in ("parallel", "trainer"):
        for when in ("warm_up", "per_replay"):
            c = res[when][what]
            check(c["SK"] == 1 and c["SS"] == 1 and c["GB"] == 0,
                  f"{what} loop under sortseg, {when}: launches {c}, expected SK and SS once "
                  f"and no GB")
    got, want = res["losses"]["parallel"], res["losses"]["trainer"]
    check(bool(np.isfinite(got).all()) and got[-1] < got[0],
          f"the DataParallel loop under sortseg: losses {got}")
    # at one rank the step calls no collective: the two loops run the same kernels
    check(got == want and res["same_weights"],
          f"the DataParallel loop under sortseg against Trainer.make_training_loop: losses "
          f"{got} and {want}, weights equal {res['same_weights']}")
    print(f"DataParallel loop under sortseg: captured, SK and SS once in the warm-up and in "
          f"each replay, no GB; losses {got[0]:.6f} -> {got[-1]:.6f}, and the trained weights, "
          f"equal to Trainer.make_training_loop's bit for bit")
    reset_counts()
    print(f"slice 19: the phase took {time.time() - t_phase:.1f} s")

    out = []
    path = (f"config_hash (BF16_POLICY) through make_training_loop under TCNN_TPU_SCATTER="
            f"sortseg, {SORTSEG_STEPS} steps at B={MAIN_BATCH} (the warm-up step and the "
            f"captured one)")
    for k in ("SK", "SS"):
        extra = {"path": path, "batch": MAIN_BATCH, "sort_ms": t["sort config_hash"],
                 "route_ms": t["route config_hash"], "gb_ms": t["GB config_hash"],
                 "config_btf_ms": t[f"{k} config_btf"],
                 "config_btf_bound_ms": t[f"{k} config_btf bound"]}
        if k == "SS":
            extra.update({
                lab + suffix: t[f"SS {cell} {what}"]
                for cell, lab in (("config_hash", ""), ("config_btf", "config_btf_"))
                for what, suffix in (("gather floor", "gather_floor_ms"),
                                     ("deterministic library", "deterministic_library_ms"))})
            extra["config_btf_library_ms"] = t["SS config_btf library"]
        out += entries(t, [(f"{k} config_hash", k, REPLACES_SORTSEG)], launches, err, extra)
    return out


# Slice 21: the compiled single step (Trainer.make_training_step; the SDF and
# NeRF samples replay a captured step as the JAX samples jit theirs).
COMPILED_STEPS = 20          # steps through the compiled step, and as many eager ones
COMPILED_REPS = 5            # timed passes of COMPILED_STEPS steps; the least is kept
COMPILED_SDF_POWS = (14, 18)
# The port's 500-step SDF fit at 2^14 on the CPU (the JAX sample's: loss
# 0.017435, error 0.0675): the compiled fit ends within a factor 1.5 of the
# loss and within 0.01 of the error.
SDF_FIT_LOSS_REF, SDF_FIT_LOSS_FACTOR = 0.019, 1.5
SDF_FIT_ERROR_REF, SDF_FIT_ERROR_ATOL = 0.067, 0.01
# The fit with every step eager read 37.03 dB (H100 80GB HBM3, 700 W).
NERF_PSNR_EAGER, NERF_PSNR_ATOL = 37.03, 1.0


def host_step_ms(fn, n=COMPILED_STEPS, reps=COMPILED_REPS):
    """Host-clock ms per step: n back-to-back calls of fn() (one step
    each) from an idle card to the end of the last one's device work, the
    least of reps passes (a pass's own cost on a shared host, as
    ``tools/kernel_ablation.py``'s ``host_ms`` reads the least)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / n)
    return best


def replay_ms(graph, n=N_TIMED, reps=5):
    """Device ms per replay of a captured step: n replays back to back
    between CUDA events, the median of reps."""
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def step_times(label, t, eager, replayed, graph):
    """The eager and replayed ms per step on the host clock and the
    replayed step's device ms, into ``t`` under ``label``, printed."""
    t[label] = {"eager": host_step_ms(eager), "replayed": host_step_ms(replayed),
                "device": replay_ms(graph)}
    r = t[label]
    print(f"{label}: eager {r['eager']:.4f} ms per step on the host clock, replayed "
          f"{r['replayed']:.4f} ({r['eager'] / r['replayed']:.2f}x), the replayed step on the "
          f"device {r['device']:.4f} ms (idle share {1 - r['device'] / r['replayed']:.3f}; "
          f"eager {1 - r['device'] / r['eager']:.3f})")


def compiled_entries(entries, keep, launches, path, tag="slice 21", what="step"):
    """Report entries of a compiled path: each kernel's numbers from its
    earlier phase in this run (the same shapes; ``keep`` selects the
    entries by name), the launches from this phase's run of the path."""
    out = []
    for e in entries:
        k = next((k for k, (name, _) in KERNELS.items() if e["name"].split(" (")[0] == name),
                 None)
        if k is not None and keep(e["name"]):
            entry = {key: v for key, v in e.items()
                     if key not in ("launches_inference", "launches_per_step", "phase_launches",
                                    "path")}
            entry.update(name=f"{e['name']} ({tag}: {path})", launches=launches[k],
                         path=f"{path}: the warm-up {what} and the capture launch it, the "
                              f"replays launch it from the graph")
            out.append(entry)
    return out


def compiled_step_slice(gen, dev, hash_entries, sdf_entries, nerf_entries):
    """Slice 21, the compiled single step.  (a) config_hash (BF16_POLICY,
    2^18) through ``Trainer.make_training_step``: under
    ``TCNN_TPU_SCATTER=sortseg`` ``COMPILED_STEPS`` steps end with the same
    weights and losses, bit for bit, as as many eager ``training_step``s
    from the same seed; without it the same steps are the main path (G, M,
    GB, MB launched in the warm-up and the capture only) and their losses
    within ``PARALLEL_LOSS_RTOL`` of the eager ones'; each call's loss is
    its own tensor; Shampoo (slice 23) under sortseg replays its eager
    steps bit for bit.  (b) The SDF sample's eikonal step at
    2^14 and 2^18 captured through the trainer's capture helper: a replayed
    step's loss and gradients against an eager step's from the same
    weights at the eikonal step's bounds; then ``fit_sdf_eikonal.main``
    (500 steps at 2^14), the main path, near the CPU fit's loss and error.
    (c) The NeRF step at the sample's defaults: an eager step with no host
    sync (``torch.cuda.set_sync_debug_mode("error")``) and its capture;
    a replayed step's loss and gradients against an eager step's at the
    NeRF step's bounds; ``fit_nerf_field.main``, the main path, within
    ``NERF_PSNR_ATOL`` of the eager fit's PSNR.  Each path's eager and replayed ms
    per step on the host clock and the replayed step's device ms.  Returns
    the kernels' entries: launches from this phase's main paths, the rest
    from the kernels' own phases of this run."""
    import functools

    from tcnn_tpu_torch import (BF16_POLICY, Policy, create_from_config, create_optimizer,
                                load_config)
    from tcnn_tpu_torch.samples import fit_nerf_field as nf
    from tcnn_tpu_torch.samples import fit_sdf_eikonal as sdf
    from tcnn_tpu_torch.tools.plain_path import plain_sdf_loss_and_grads
    from tcnn_tpu_torch.trainer import _capture_step
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image

    t_start = time.time()
    t = {}
    sampler = ImageSampler(synthetic_image(1024, 1024), seed=5)
    batches = [sampler.sample_batch(MAIN_BATCH) for _ in range(COMPILED_STEPS)]

    def hash_run(compiled):
        model = create_from_config(2, 3, CONFIG, policy=BF16_POLICY, seed=21)
        step = model.trainer.make_training_step() if compiled else model.trainer.training_step
        torch.cuda.synchronize()
        reset_counts()
        losses = [step(x, target) for x, target in batches]
        torch.cuda.synchronize()
        return (model, losses, all_counts(),
                [p.detach().clone() for p in model.trainer.params().values()])

    phase(f"slice 21: config_hash (BF16_POLICY) through Trainer.make_training_step under "
          f"TCNN_TPU_SCATTER=sortseg, {COMPILED_STEPS} steps at B={MAIN_BATCH}, against as many "
          f"eager training_steps from the same seed")
    set_sortseg(True)
    try:
        _, want, _, want_w = hash_run(False)
        model, got, launches, got_w = hash_run(True)
    finally:
        set_sortseg(False)
    same_w = [torch.equal(a, b) for a, b in zip(got_w, want_w)]
    check(torch.equal(torch.stack(got), torch.stack(want)) and all(same_w),
          f"sortseg: the compiled steps' losses or weights differ from the eager steps' "
          f"(weights equal per parameter: {same_w})")
    check(launches["GB"] == 0 and all(launches[k] == 2 for k in ("G", "M", "MB", "SK", "SS")),
          f"sortseg compiled steps: launches {launches}, expected G, M, MB, SK, SS twice (the "
          f"warm-up and the capture) and no GB")
    check(model.trainer.step == COMPILED_STEPS, f"step count {model.trainer.step}")
    print(f"{COMPILED_STEPS} compiled steps equal {COMPILED_STEPS} eager ones bit for bit: "
          f"every loss and every weight ({sum(w.numel() for w in got_w)} values); loss "
          f"{float(got[0]):.6f} -> {float(got[-1]):.6f}; launches {launches}")

    phase(f"slice 21: config_hash through Trainer.make_training_step, {COMPILED_STEPS} steps "
          f"at B={MAIN_BATCH} (the main path), against as many eager steps")
    _, want, _, _ = hash_run(False)
    model, got, hash_launches, _ = hash_run(True)
    got, want = torch.stack(got), torch.stack(want)
    rtol = torch.full_like(want, PARALLEL_LOSS_RTOL)
    rtol[0] = PARALLEL_FIRST_RTOL
    check(bool(((got - want).abs() <= rtol * want.abs()).all()) and float(got[-1]) < float(got[0]),
          f"compiled losses {got.tolist()} vs eager {want.tolist()}")
    check(hash_launches["SK"] == hash_launches["SS"] == 0
          and {k: hash_launches[k] for k in FIRST_ORDER} == {"G": 2, "M": 2, "GB": 2, "MB": 2}
          and all(hash_launches[k] == 0 for k in ("GI", "GG", "RS", "GT", "MW", "MBW")),
          f"compiled steps' launches {hash_launches}, expected G, M, GB and MB twice")
    step = model.trainer.make_training_step()
    (key, cap), = [(k, c) for k, c in model.trainer._graphs.items()
                   if k[0] == "make_training_step"]
    x, target = batches[0]
    a = step(x, target)
    a_copy = a.clone()
    step(x, target)
    check(a.data_ptr() != cap.outputs[0].data_ptr() and torch.equal(a, a_copy),
          "a compiled step's loss aliases the graph's")
    print(f"losses {float(got[0]):.6f} -> {float(got[-1]):.6f}, within "
          f"{float(((got - want).abs() / want.abs()).max()):.3e} of the eager steps' (first "
          f"rtol {PARALLEL_FIRST_RTOL}, the rest {PARALLEL_LOSS_RTOL}: GB's atomics); launches "
          f"{hash_launches}; each call's loss a tensor of its own")
    step_times(f"config_hash step at B={MAIN_BATCH}", t,
               lambda: model.trainer.training_step(x, target), lambda: step(x, target), cap.graph)
    # Shampoo since slice 23: kernel SR reads the counter at each replay.
    shampoo_cfg = {**load_config(CONFIG), "optimizer": SHAMPOO}
    set_sortseg(True)
    try:
        runs = []
        for compiled in (True, False):
            sh = create_from_config(2, 3, shampoo_cfg, policy=BF16_POLICY, seed=21)
            step_sh = sh.trainer.make_training_step() if compiled else sh.trainer.training_step
            sr0 = shampoo_counters()["SR"].launches
            ls = torch.stack([step_sh(*b) for b in batches[:SHAMPOO_STEP_STEPS]])
            torch.cuda.synchronize()
            runs.append((ls, shampoo_leaves(sh), shampoo_counters()["SR"].launches - sr0))
    finally:
        set_sortseg(False)
    check(torch.equal(runs[0][0], runs[1][0])
          and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
          and runs[0][2] == 2, f"Shampoo under make_training_step (sortseg): losses or "
          f"leaves differ from eager steps', or SR launched {runs[0][2]} times (expected 2)")
    print(f"Shampoo under make_training_step, sortseg: {SHAMPOO_STEP_STEPS} replayed steps "
          f"(refreshes at t = 1 and 10) equal as many eager ones bit for bit, losses, weights "
          f"and every state leaf; SR launched twice (warm-up, capture)")

    for pow_ in COMPILED_SDF_POWS:
        B = 1 << pow_
        phase(f"slice 21: the SDF sample's eikonal step at B=2^{pow_}, captured: a replayed "
              f"step against an eager one from the same weights, and both steps' times")
        m = create_from_config(3, 1, sdf.CONFIG, policy=Policy(), seed=21)
        net, opt = m.network, m.optimizer
        opt_state = opt.init(dict(net.named_parameters()), net.param_layout())
        xs, xv = sdf.sample_points(gen, B, dev)
        names = [n for n, _ in net.named_parameters()]

        def grads_body(a, b):
            (loss, sl, el), grads = sdf.loss_and_grads(net, a, b, aux=True)
            return (loss, sl, el, *grads.values())

        cap_g, _ = _capture_step(grads_body, (xs, xv))
        replayed = cap_g(xs, xv)
        eager = grads_body(xs, xv)
        _, _, scale = plain_sdf_loss_and_grads(net, xs, xv, table_scale=True)
        for i, what in enumerate(("loss", "surface", "eikonal")):
            check(abs(replayed[i].item() - eager[i].item()) <= 1e-4 * abs(eager[i].item()),
                  f"SDF 2^{pow_}: replayed {what} {replayed[i].item()} vs eager {eager[i].item()}")
        hows = []
        for n, g, w in zip(names, replayed[3:], eager[3:]):
            if n == "encoding.grid":
                e = compare_table_grad(g, w, scale, f"SDF 2^{pow_} replayed {n}")
            else:
                e = compare_rel(g, w, 1e-4, f"SDF 2^{pow_} replayed {n}")
            hows.append(f"{n} {e:.3e}")
        print(f"replayed against eager from the same weights: loss {replayed[0].item():.6f} "
              f"(eager {eager[0].item():.6f}); gradients' max abs diff: {', '.join(hows)} "
              f"(table 2^-11·S, weights 1e-4 of their max)")
        cap, _ = _capture_step(functools.partial(sdf.step, net, opt, opt_state), (xs, xv))
        step_times(f"SDF eikonal step at B=2^{pow_}", t,
                   lambda: sdf.step(net, opt, opt_state, xs, xv), lambda: cap(xs, xv), cap.graph)

    phase(f"slice 21: fit_sdf_eikonal.main, {SDF_FIT_STEPS} steps at 2^{SDF_FIT_BATCH_POW}, "
          f"a captured step replayed (the main path)")
    torch.cuda.synchronize()
    reset_counts()
    fit = sdf.main(["fit_sdf_eikonal", str(SDF_FIT_STEPS), str(SDF_FIT_BATCH_POW)])
    torch.cuda.synchronize()
    sdf_launches = counts()
    want = {"G": 5, "M": 5, "MB": 4, "GB": 2, "GI": 2, "GG": 2, "RS": 0, "GT": 0, "MW": 0,
            "MBW": 0}   # per step G, M, MB 2 and GB, GI, GG 1; twice; G and M for the evaluation
    check(sdf_launches == want, f"SDF fit launches {sdf_launches}, expected {want}")
    last10 = float(fit["losses"][-10:].mean())
    check(bool(torch.isfinite(fit["losses"]).all())
          and SDF_FIT_LOSS_REF / SDF_FIT_LOSS_FACTOR <= last10
          <= SDF_FIT_LOSS_REF * SDF_FIT_LOSS_FACTOR
          and abs(fit["sdf_error"] - SDF_FIT_ERROR_REF) <= SDF_FIT_ERROR_ATOL,
          f"SDF fit: loss {last10}, sdf error {fit['sdf_error']}")
    t["SDF fit s"] = fit["seconds"]
    print(f"fit: loss {float(fit['losses'][0]):.6f} -> {last10:.6f} (mean of the last 10; "
          f"the CPU fit's {SDF_FIT_LOSS_REF}, within a factor {SDF_FIT_LOSS_FACTOR}), mean |sdf error| "
          f"{fit['sdf_error']:.4f} (the CPU fit's {SDF_FIT_ERROR_REF} ± {SDF_FIT_ERROR_ATOL}); "
          f"{fit['seconds']:.3f} s, {fit['seconds'] / SDF_FIT_STEPS * 1e3:.4f} ms a step; "
          f"launches {sdf_launches}")

    phase(f"slice 21: the NeRF step at the sample's defaults ({NERF_RAYS} rays x "
          f"{NERF_SAMPLES} samples, BF16_POLICY): an eager step with no host sync, its capture, "
          f"a replayed step against an eager one from the same weights, both steps' times")
    d_net, c_net = nf.build_model(BF16_POLICY, torch.Generator().manual_seed(0), dev)
    opt = create_optimizer(nf.OPTIMIZER)
    opt_state = opt.init(*nf.params_and_layout(d_net, c_net))
    rays_o, rays_d = nf.sample_rays(gen, NERF_RAYS, dev)
    jitter = torch.rand((NERF_RAYS, NERF_SAMPLES), generator=gen, device=dev)
    inputs = (rays_o, rays_d, jitter, nf.per_sample_frac(0.5, NERF_BATCH, dev))

    def nerf_step(o, d, j, frac):
        return nf.step(d_net, c_net, opt, opt_state, o, d, NERF_SAMPLES, j, frac)

    def nerf_grads(o, d, j, frac):
        loss, grads = nf.loss_and_grads(d_net, c_net, o, d, NERF_SAMPLES, j, frac)
        return (loss, *grads.values())

    nerf_grads(*inputs)   # the level constants and the scene's tensors, cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nerf_grads(*inputs)   # raises on an operation that waits for the device
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cap_g, _ = _capture_step(nerf_grads, inputs)
    replayed = cap_g(*inputs)
    eager = nerf_grads(*inputs)
    check(abs(replayed[0].item() - eager[0].item()) <= 2e-2 * abs(eager[0].item()),
          f"NeRF: replayed loss {replayed[0].item()} vs eager {eager[0].item()}")
    names = list(nf.params_and_layout(d_net, c_net)[0])
    e = compare_mlp_grads(list(replayed[1:]), list(eager[1:]), torch.bfloat16,
                          "NeRF replayed gradients")
    print(f"an eager NeRF step ran under torch.cuda.set_sync_debug_mode('error'): no host sync; "
          f"captured in 'global' mode; replayed against eager from the same weights: loss "
          f"{replayed[0].item():.6f} (eager {eager[0].item():.6f}), gradients of {names} within "
          f"{e:.3e} (2e-2 of each one's max)")
    cap, _ = _capture_step(nerf_step, inputs)
    step_times(f"NeRF step at B={NERF_BATCH}, frac 0.5", t, lambda: nerf_step(*inputs),
               lambda: cap(*inputs), cap.graph)

    phase(f"slice 21: fit_nerf_field.main at its defaults ({NERF_STEPS} steps), a captured "
          f"step replayed (the main path)")
    torch.cuda.synchronize()
    reset_counts()
    nfit = nf.main(["fit_nerf_field"])
    torch.cuda.synchronize()
    nerf_launches = first_order_counts()
    check(nerf_launches == {"G": 3, "M": 6, "GB": 2, "MB": 4},
          f"NeRF fit launches {nerf_launches}, expected the step in the warm-up and the "
          f"capture and the evaluation (G 3, M 6, GB 2, MB 4)")
    check(bool(torch.isfinite(nfit["losses"]).all())
          and abs(nfit["psnr"] - NERF_PSNR_EAGER) <= NERF_PSNR_ATOL,
          f"NeRF fit PSNR {nfit['psnr']:.2f} dB, the eager fit's {NERF_PSNR_EAGER} ± "
          f"{NERF_PSNR_ATOL}")
    t["NeRF fit s"] = nfit["seconds"]
    print(f"fit: {NERF_STEPS} steps in {nfit['seconds']:.3f} s "
          f"({nfit['seconds'] / NERF_STEPS * 1e3:.4f} ms a step); loss "
          f"{float(nfit['losses'][:10].mean()):.6f} (first 10) -> "
          f"{float(nfit['losses'][-10:].mean()):.6f} (last 10); eval PSNR {nfit['psnr']:.2f} dB "
          f"(the eager fit's {NERF_PSNR_EAGER} ± {NERF_PSNR_ATOL}); launches {nerf_launches}")
    print(f"slice 21: {time.time() - t_start:.1f} s; the SDF and NeRF phases' fits (slices 4, "
          f"8 and 16) replay the same captured steps now")
    return (compiled_entries(hash_entries, lambda n: " (" not in n, hash_launches,
                             "config_hash make_training_step")
            + compiled_entries(sdf_entries, lambda n: not n.startswith("row_scatter")
                               and (n.endswith(" (sdf)") or n.endswith(" (sdf 2^14)")),
                               sdf_launches,
                               "fit_sdf_eikonal.main, 500 steps at 2^14")
            + compiled_entries(nerf_entries, lambda n: True, nerf_launches,
                               "fit_nerf_field.main"))


# Slice 23: Shampoo in the compiled paths; kernel SR (csrc/shampoo_root.cu)
# refreshes its roots on the device.
SHAMPOO = {"otype": "Shampoo", "learning_rate": 1e-2}
SHAMPOO_STEP_STEPS = 12        # slice 21's compiled Shampoo steps (refreshes at t = 1, 10)
SHAMPOO_LOOP_STEPS = 250       # the captured loop against eager steps, t = 1 ... 250
SHAMPOO_TIMED_STEPS = 200      # the timed loop calls
ONEBLOB_TIMED_STEPS = 100      # config_oneblob's timed loop calls
SR_ALONE = (256, 512, 600)     # the wide SDF's, the wide image's first and the 600-output layers
SR_IDENTITY = 0.01
SR_SPAN = 1e5                  # the spectrum of the random matrices, as a trained MLP's
REPLACES_SR = ("none (XLA eigh): tcnn_tpu/optimizers/shampoo.py:43 (_inverse_4th_root_psd) "
               "under the lax.cond of tcnn_tpu/optimizers/shampoo.py:166-176")
KERNELS["SR"] = ("shampoo_root", "tcnn_tpu_torch/csrc/shampoo_root.cu")


def shampoo_counters():
    from tcnn_tpu_torch.ops.cuda.shampoo_root import shampoo_refresh_roots

    return {"SR": shampoo_refresh_roots}


def shampoo_leaves(model):
    """Copies of the parameters and of every optimizer state leaf."""
    from tcnn_tpu_torch.optimizers.base import tree_leaves

    return ([p.detach().clone() for p in model.trainer.params().values()]
            + [t.clone() for t in tree_leaves(model.trainer.opt_state)])


def preconditioners(model):
    """The model's Shampoo matrices (L and R of each weight matrix) and
    their roots, in the order the optimizer hands them to SR."""
    mats = [st for st in model.trainer.opt_state["mat"].values() if st]
    return ([st[k] for st in mats for k in ("L", "R")],
            [st[k + "_root"] for st in mats for k in ("L", "R")])


def sr_case(label, mats, t, reps):
    """Kernel SR on ``mats`` at a refresh step against the float64 roots
    of the same float32 S (``root_error`` within ``ROOT_TOL``), beside the
    plain version's error (float32 eigh on the card) and a control that
    must fail (each matrix from n = 16 again, SR stopped at half its
    sweeps); the times of one launch: refreshing (``reps`` back-to-back
    launches; with one, the second launch, which also checks the bits), on
    a step that is none, the plain version (eigh per matrix, eager) and
    the library yardstick (``torch.linalg.eigh`` and the two products, per
    matrix, eager); its bound from the function's work, not the sweeps
    this run took; into ``t[label]``, printed."""
    from tcnn_tpu_torch.ops.cuda import kernels
    from tcnn_tpu_torch.ops.cuda.shampoo_root import shampoo_refresh_roots
    from tcnn_tpu_torch.optimizers.shampoo import inverse_4th_root_psd
    from tcnn_tpu_torch.tools.plain_path import ROOT_TOL, float64_root, root_error

    dev = mats[0].device
    refresh = torch.tensor(10, dtype=torch.int32, device=dev)
    idle = torch.tensor(11, dtype=torch.int32, device=dev)
    roots = [torch.zeros_like(a) for a in mats]
    stats = torch.zeros((len(mats), 2), dtype=torch.int32, device=dev)
    shampoo_refresh_roots(refresh, mats, roots, SR_IDENTITY, stats)
    torch.cuda.synchronize()
    sweeps, rotations = stats[:, 0].tolist(), stats[:, 1].tolist()
    cap = kernels().shampoo_root_max_sweeps
    check(max(sweeps) < cap, f"SR {label}: sweeps {sweeps} reached the cap {cap}")
    errs, plain_errs, controls, abs_err = [], [], [], 0.0
    for a, root, sw in zip(mats, roots, sweeps):
        err = root_error(root, a, SR_IDENTITY)
        check(bool(torch.isfinite(root).all()) and err <= ROOT_TOL,
              f"SR {label} n={a.shape[0]}: root error {err:.3e} beyond ROOT_TOL {ROOT_TOL:.3e}")
        errs.append(err)
        abs_err = max(abs_err, float((root.cpu().double()
                                      - float64_root(a, SR_IDENTITY)).abs().max()))
        plain_errs.append(root_error(inverse_4th_root_psd(a, SR_IDENTITY), a, SR_IDENTITY))
        if a.shape[0] >= 16:
            early = torch.zeros_like(a)
            shampoo_refresh_roots(refresh, [a], [early], SR_IDENTITY, max_sweeps=max(1, sw // 2))
            controls.append(root_error(early, a, SR_IDENTITY))
            check(controls[-1] > ROOT_TOL, f"SR {label} n={a.shape[0]}: stopped at {sw // 2} of "
                  f"{sw} sweeps, its root error {controls[-1]:.3e} lies within ROOT_TOL")
    again = [torch.zeros_like(a) for a in mats]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    shampoo_refresh_roots(refresh, mats, again, SR_IDENTITY)
    end.record()
    end.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(roots, again)), f"SR {label}: bits differ "
          "between two launches")

    def library():
        for a in mats:
            w, v = torch.linalg.eigh(0.5 * (a + a.t()) * (1 - SR_IDENTITY)
                                     + SR_IDENTITY * torch.eye(a.shape[0], device=dev))
            (v * w.clamp_min(1e-12) ** -0.25) @ v.t()

    r = {"ms": (eager_ms(lambda: shampoo_refresh_roots(refresh, mats, again, SR_IDENTITY),
                         n=reps) if reps > 1 else start.elapsed_time(end)),
         "no_refresh_ms": graph_ms(lambda: shampoo_refresh_roots(idle, mats, again, SR_IDENTITY)),
         "plain_ms": eager_ms(lambda: [inverse_4th_root_psd(a, SR_IDENTITY) for a in mats],
                              n=reps),
         "library_ms": eager_ms(library, n=reps)}
    ns = [a.shape[0] for a in mats]
    n_bytes = sum(2 * n * n * 4 for n in ns)   # each L read, each root written
    # the function's work a matrix: an eigendecomposition with vectors about
    # 9n³ (the symmetric QR algorithm, its rotations accumulated), the root's
    # product 2n³
    flops = sum(11 * n ** 3 for n in ns)
    r.update(bound_ms=bound_ms(n_bytes, flops, PEAK_FP32),
             bound_by=bound_by(n_bytes, flops, PEAK_FP32), max_abs_err=abs_err,
             root_error=max(errs), plain_root_error=max(plain_errs),
             control_root_error=min(controls) if controls else None, root_tol=ROOT_TOL,
             sweeps=max(sweeps), rotations=sum(rotations), sizes=ns)
    t[label] = r
    ctrl = f"{min(controls):.3e}" if controls else "none (n < 16)"
    print(f"SR {label} (n = {ns}): root error {max(errs):.3e} of the root's largest entry "
          f"(ROOT_TOL {ROOT_TOL:.3e}; max abs {abs_err:.3e}); float32 eigh {min(plain_errs):.3e}"
          f"-{max(plain_errs):.3e}; the control, half the sweeps, {ctrl} at least; sweeps "
          f"{sweeps}, {sum(rotations)} rotations; {r['ms']:.4f} ms a refresh launch, "
          f"{r['no_refresh_ms']:.4f} ms a launch on a step that is none; plain (eigh per "
          f"matrix) {r['plain_ms']:.4f} ms, library (eigh and two products) "
          f"{r['library_ms']:.4f} ms; bound {r['bound_ms']:.6f} ms ({n_bytes / 1e6:.3f} MB, "
          f"{flops / 1e9:.4f} GFLOP on the fp32 FMA units)")
    return r


def shampoo_slice(gen, dev):
    """Slice 23, Shampoo in the compiled paths.  (a) The main path:
    config_hash (BF16_POLICY, 2^18) with Shampoo under
    ``TCNN_TPU_SCATTER=sortseg`` through ``make_training_loop``,
    ``SHAMPOO_LOOP_STEPS`` steps, against as many eager ``training_step``s
    from the same seed, bit for bit (losses, weights, every state leaf);
    the roots, copied by ``sample_fn`` before each replay, change at
    exactly the refresh steps t = 1, 10, ..., 90, 200.  (b) Kernel SR
    against the float64 roots of the same float32 S within ``ROOT_TOL``,
    with float32 eigh's error and a control beside it: config_hash's six
    preconditioners from (a), config_oneblob's twelve, and random
    matrices spanning 10^5 at n = 256, 512 and 600 alone; its times
    (``sr_case``).  (c) The times of Shampoo at config_hash without
    sortseg: the loop's ms per step over ``SHAMPOO_TIMED_STEPS`` steps,
    samples/s and idle share (Adam's loop beside it), the compiled and
    the eager step on the host clock, the optimizer step alone eager and
    replayed; config_oneblob's loop with Shampoo and with Adam.  (d) In a
    spawned one-rank NCCL process (``parallel_check.nccl_compiled_job``
    with Shampoo), DataParallel's and HybridParallel's (n_model 1)
    ``make_training_step`` under sortseg against ``step_shard_map`` eager
    steps and ``Trainer.make_training_step``, bit for bit.  Returns SR's
    report entry: launches from (a), times at config_hash's six roots, the
    other shapes as extra fields."""
    import tempfile

    from tcnn_tpu_torch import BF16_POLICY, create_from_config, load_config
    from tcnn_tpu_torch.optimizers.shampoo import refresh_due
    from tcnn_tpu_torch.tools import parallel_check
    from tcnn_tpu_torch.tools.plain_path import spanning_psd
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image

    t_start = time.time()
    sr = {}
    cfg = {**load_config(CONFIG), "optimizer": SHAMPOO}
    image = synthetic_image(1024, 1024)
    sampler = ImageSampler(image, seed=23)
    batches = [sampler.sample_batch(MAIN_BATCH) for _ in range(SHAMPOO_LOOP_STEPS)]

    phase(f"slice 23: config_hash (BF16_POLICY) with Shampoo through make_training_loop under "
          f"TCNN_TPU_SCATTER=sortseg, {SHAMPOO_LOOP_STEPS} steps at B={MAIN_BATCH} (the main "
          f"path), against as many eager training_steps from the same seed")
    set_sortseg(True)
    try:
        model = create_from_config(2, 3, cfg, policy=BF16_POLICY, seed=23)
        _, roots = preconditioners(model)
        snaps = []

        def sample(i):   # the roots after step i, copied before the replay of step i + 1
            snaps.append(torch.cat([r.flatten() for r in roots]))
            return batches[i]

        torch.cuda.synchronize()
        reset_counts()
        losses = model.trainer.make_training_loop(sample, SHAMPOO_LOOP_STEPS)()
        snaps.append(torch.cat([r.flatten() for r in roots]))
        torch.cuda.synchronize()
        launches = all_counts()
        eager = create_from_config(2, 3, cfg, policy=BF16_POLICY, seed=23)
        want = torch.stack([eager.trainer.training_step(*b) for b in batches])
        torch.cuda.synchronize()
    finally:
        set_sortseg(False)
    got_leaves, want_leaves = shampoo_leaves(model), shampoo_leaves(eager)
    same = [torch.equal(a, b) for a, b in zip(got_leaves, want_leaves)]
    check(torch.equal(losses, want) and all(same),
          f"the captured Shampoo loop against eager steps: losses equal "
          f"{torch.equal(losses, want)}, leaves equal {same}")
    changed = [i for i in range(1, len(snaps)) if not torch.equal(snaps[i], snaps[i - 1])]
    due = [i for i in range(1, SHAMPOO_LOOP_STEPS + 1)
           if bool(refresh_due(torch.tensor(i)))]
    check(changed == due, f"the roots changed at t = {changed}, the refresh steps are {due}")
    check(launches["SR"] == 2 and launches["GB"] == 0
          and all(launches[k] == 2 for k in ("G", "M", "MB", "SK", "SS")),
          f"the Shampoo loop's launches {launches}: expected SR, G, M, MB, SK and SS twice "
          f"(the warm-up and the capture) and no GB")
    check(bool(torch.isfinite(losses).all()) and float(losses[-10:].mean()) < float(losses[0]),
          f"the Shampoo loop did not train: {float(losses[0])} -> {float(losses[-1])}")
    print(f"{SHAMPOO_LOOP_STEPS} replayed steps equal {SHAMPOO_LOOP_STEPS} eager ones bit for "
          f"bit: every loss, weight and state leaf ({sum(v.numel() for v in got_leaves)} "
          f"values); loss {float(losses[0]):.6f} -> {float(losses[-10:].mean()):.6f} (mean of "
          f"the last 10); the roots changed at t = {changed}, exactly the refresh steps; "
          f"launches {launches}")

    phase("slice 23: kernel SR against float64 roots, and its times: config_hash's and "
          f"config_oneblob's preconditioners, n = {', '.join(map(str, SR_ALONE))} alone")
    hash_mats = [m.clone() for m in preconditioners(model)[0]]
    sr_case("config_hash", hash_mats, sr, 10)
    oneblob = create_from_config(2, 3, {**load_config(ONEBLOB_CONFIG), "optimizer": SHAMPOO},
                                 policy=BF16_POLICY, seed=23)
    for b in batches[:10]:
        oneblob.trainer.training_step(*b)
    sr_case("config_oneblob", [m.clone() for m in preconditioners(oneblob)[0]], sr, 10)
    for n in SR_ALONE:   # a cluster of 16 CTAs a matrix above n = 192
        sr_case(f"n={n}", [spanning_psd(n, dev, SR_SPAN, SR_IDENTITY)], sr, 1)

    phase(f"slice 23: Shampoo's times at config_hash, B={MAIN_BATCH}, the default route "
          f"(GB), beside Adam's")
    x, target = batches[0]
    timed = {}
    for name, ocfg in (("Shampoo", SHAMPOO), ("Adam", load_config(CONFIG)["optimizer"])):
        m = create_from_config(2, 3, {**cfg, "optimizer": ocfg}, policy=BF16_POLICY, seed=23)
        loop = m.trainer.make_training_loop(lambda i: batches[i], SHAMPOO_TIMED_STEPS)
        loop()   # the capture, and t = 1 ... 200
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()   # t = 201 ... 400: refreshes at 400
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / SHAMPOO_TIMED_STEPS
        (cap,) = [c for k, c in m.trainer._graphs.items() if k[0] != "make_training_step"]
        device = replay_ms(cap.graph)
        step = m.trainer.make_training_step()
        r = {"loop_ms": host, "samples_per_s": MAIN_BATCH / host * 1e3, "device_ms": device,
             "idle_share": 1 - device / host,
             "compiled_step_ms": host_step_ms(lambda: step(x, target)),
             "eager_step_ms": host_step_ms(lambda: m.trainer.training_step(x, target))}
        _, grads = m.trainer.loss_value_and_grads(x, target)

        def opt_step():
            m.optimizer.step(m.trainer.opt_state, grads, m.trainer.params())

        r["opt_eager_ms"], r["opt_replayed_ms"] = eager_ms(opt_step), graph_ms(opt_step)
        timed[name] = r
        print(f"{name} at config_hash: make_training_loop {host:.4f} ms per step on the host "
              f"clock ({SHAMPOO_TIMED_STEPS} steps, t = 201-400), {r['samples_per_s']:.4e} "
              f"samples/s, the replayed step {device:.4f} ms on the device (idle share "
              f"{r['idle_share']:.3f}); make_training_step {r['compiled_step_ms']:.4f} ms, eager "
              f"training_step {r['eager_step_ms']:.4f} ms a step (host clock, least of "
              f"{COMPILED_REPS} passes of {COMPILED_STEPS}); the optimizer step alone "
              f"{r['opt_eager_ms']:.4f} ms eager, {r['opt_replayed_ms']:.4f} ms replayed "
              f"(device, steps past t = 400: no refresh among them but t = 600)")
    ob = {}
    ob_sampler = ImageSampler(image, seed=24)
    for name, ocfg in (("Shampoo", SHAMPOO), ("Adam", load_config(ONEBLOB_CONFIG)["optimizer"])):
        m = create_from_config(2, 3, {**load_config(ONEBLOB_CONFIG), "optimizer": ocfg},
                               policy=BF16_POLICY, seed=23)
        loop = m.trainer.make_training_loop(lambda i: ob_sampler.sample_batch(MAIN_BATCH),
                                            ONEBLOB_TIMED_STEPS)
        loop()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ob_losses = loop()   # t = 101 ... 200: the refresh at 200
        torch.cuda.synchronize()
        ob[name] = (time.perf_counter() - t0) * 1e3 / ONEBLOB_TIMED_STEPS
        check(bool(torch.isfinite(ob_losses).all()), f"config_oneblob {name}: non-finite loss")
    print(f"config_oneblob make_training_loop at B={MAIN_BATCH}: Shampoo {ob['Shampoo']:.4f} ms "
          f"per step, Adam {ob['Adam']:.4f} ms (calls of {ONEBLOB_TIMED_STEPS} steps, t = "
          f"101-200, host clock)")

    phase(f"slice 23: Shampoo under DataParallel and HybridParallel (n_model 1) "
          f"make_training_step on a one-rank NCCL group, sortseg, {NCCL_COMPILED_STEPS} steps")
    with tempfile.TemporaryDirectory() as tmp:
        res, = parallel_check.run_ranks(1, parallel_check.nccl_compiled_job,
                                        {"steps": NCCL_COMPILED_STEPS, "batch": MAIN_BATCH,
                                         "rounds": 1, "optimizer": SHAMPOO, "main": False},
                                        timeout=600, tmp=tmp, backend="nccl")
    check(res["backend"] == "nccl", f"the group's backend is {res['backend']}")
    for kind, r in res["sortseg"].items():
        check(r["same_as_eager"] and r["same_as_trainer"] and r["step"] == NCCL_COMPILED_STEPS
              and r["launches"]["SR"] == 2 and r["trainer_launches"]["SR"] == 2
              and r["eager_launches"]["SR"] == NCCL_COMPILED_STEPS,
              f"Shampoo under {kind}'s make_training_step: equal to step_shard_map's eager steps "
              f"{r['same_as_eager']}, to Trainer.make_training_step's {r['same_as_trainer']}; "
              f"launches {r['launches']}")
        print(f"{kind}: {NCCL_COMPILED_STEPS} compiled Shampoo steps equal as many "
              f"step_shard_map eager steps and Trainer.make_training_step's bit for bit (losses "
              f"and weights); loss {r['losses'][0]:.6f} -> {r['losses'][-1]:.6f}; SR launched "
              f"in the warm-up and the capture only")
    reset_counts()
    print(f"slice 23: {time.time() - t_start:.1f} s")
    h = sr["config_hash"]
    return [{"name": "shampoo_root (config_hash)", "route": "cuda", "source": KERNELS["SR"][1],
             "replaces": REPLACES_SR, "launches": launches["SR"], "max_abs_err": h["max_abs_err"],
             "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
             "bound_by": h["bound_by"], "library_ms": h["library_ms"],
             "path": f"config_hash (BF16_POLICY) with Shampoo through make_training_loop under "
                     f"TCNN_TPU_SCATTER=sortseg, {SHAMPOO_LOOP_STEPS} steps at B={MAIN_BATCH}: "
                     f"the warm-up step and the capture launch SR, each replay launches it "
                     f"from the graph, and it refreshes at t = 1, 10, ..., 90, 200",
             **{k: h[k] for k in ("no_refresh_ms", "sweeps", "rotations", "root_error",
                                  "plain_root_error", "control_root_error", "root_tol", "sizes")},
             "other_shapes": {k: v for k, v in sr.items() if k != "config_hash"},
             "shampoo_config_hash": timed, "config_oneblob_loop_ms": ob}]


# Slice 22: the compiled requests (Trainer.inference, forward, evaluate_loss)
# and the parallel layers' compiled steps and requests.
REQUEST_POWS = (10, 14, 18)      # config_hash requests; config_btf's at 2^18
EMA_REQUEST_STEPS = 10           # eager steps before the EMA request, and between two
NCCL_COMPILED_STEPS = 20         # the one-rank NCCL job's steps
NCCL_COMPILED_ROUNDS = 3         # its timed passes over them, in turns


def pool_mb(pool):
    """MB that the segments of the CUDA graph memory pool ``pool`` hold on
    the card (``torch.cuda.memory_snapshot``), or None where the snapshot
    names no segment's pool."""
    segments = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool)) / 2 ** 20


def check_request(label, trainer, x, want, t):
    """Two calls of ``trainer.inference(x)`` (the first runs and captures
    the request, the second replays it) against ``want``, the eager
    module's answer, bit for bit; G and M launched twice by the first call
    and not by the second; each answer an inference tensor of its own.
    Then one request's time, the eager module's against the compiled
    one's (``time_ms``: CUDA events around each call, so the host's work
    counts), and the replay's device ms, into ``t[label]``.  Returns the
    first call's launches."""
    torch.cuda.synchronize()
    reset_counts()
    first = trainer.inference(x)
    torch.cuda.synchronize()
    at_capture = first_order_counts()
    again = trainer.inference(x)
    torch.cuda.synchronize()
    check(first_order_counts() == at_capture == {"G": 2, "M": 2, "GB": 0, "MB": 0},
          f"{label}: launches {at_capture} at the first request, {counts()} after the second; "
          f"expected G and M twice (the warm-up and the capture), then none")
    (cap,) = [c for k, c in trainer._graphs.items()
              if k[0] == "inference" and k[3] == tuple(x.shape)]
    check(torch.equal(first, want) and torch.equal(again, want),
          f"{label}: compiled requests differ from the eager module (max abs diff "
          f"{float((again.float() - want.float()).abs().max()):.3e})")
    check(again.is_inference() and again.data_ptr() != cap.outputs[0].data_ptr()
          and first.data_ptr() != again.data_ptr(),
          f"{label}: a request returned the graph's buffer or a normal tensor")

    def eager():
        with torch.inference_mode():
            return trainer.model.inference(x)

    t[label] = {"eager": time_ms(eager), "compiled": time_ms(lambda: trainer.inference(x)),
                "device": replay_ms(cap.graph)}
    r = t[label]
    print(f"{label}: bit for bit the eager module's; one request {r['eager']:.4f} ms eager, "
          f"{r['compiled']:.4f} ms compiled ({r['eager'] / r['compiled']:.2f}x; CUDA events "
          f"around each call, the host's work included), the replay on the device "
          f"{r['device']:.4f} ms (idle share {1 - r['device'] / r['compiled']:.3f}); "
          f"{x.shape[0] / r['compiled'] * 1e3:.4e} samples/s compiled")
    return at_capture


def compiled_requests_slice(gen, dev, hash_entries, btf_entries):
    """Slice 22.  (a) ``Trainer.inference`` on config_hash (BF16_POLICY,
    the table redrawn U(±1)) at 2^10, 2^14 and 2^18 rows and on config_btf
    at 2^18 (``check_request``), the main path of the requests, with the
    memory of config_btf's graph pool; (b) EMA(Adam) at config_hash: a
    request after ``EMA_REQUEST_STEPS`` eager steps, then as many more
    steps and a replayed request against the eager module on the EMA
    weights, bit for bit (the graph computes the custom weights from the
    live optimizer state); (c) ``forward`` and ``evaluate_loss`` against
    the module and the loss, bit for bit; (d) in a spawned process on a
    one-rank NCCL group (``parallel_check.nccl_compiled_job``),
    DataParallel's and HybridParallel's (n_model 1) ``make_training_step``
    under ``TCNN_TPU_SCATTER=sortseg`` against as many ``step_shard_map``
    eager steps and ``Trainer.make_training_step`` steps, bit for bit, and
    their ``make_inference`` against the eager module; without it the
    main path of the parallel step (G, GB, M and MB in the warm-up and
    the capture only) and the steps' times.  (Slice 12's gloo ranks
    refuse each compiled entry point on the card: ``parallel_slice``.)
    Returns the kernels' entries: launches from this phase's main paths,
    the rest from the kernels' own phases of this run."""
    import tempfile

    from tcnn_tpu_torch import BF16_POLICY, create_from_config, load_config
    from tcnn_tpu_torch.tools import parallel_check
    from tcnn_tpu_torch.utils.image import ImageSampler, synthetic_image

    t_start = time.time()
    t = {}
    phase(f"slice 22: Trainer.inference compiled, config_hash (BF16_POLICY) at 2^"
          f"{', 2^'.join(map(str, REQUEST_POWS))} and config_btf at B={MAIN_BATCH}, against "
          f"the eager module")
    model = create_from_config(2, 3, CONFIG, policy=BF16_POLICY, seed=22)
    with torch.no_grad():
        model.network.encoding.grid.uniform_(-1, 1, generator=gen)
    launches = {}
    for pow_ in REQUEST_POWS:
        x = torch.rand((1 << pow_, 2), generator=gen, device=dev)
        with torch.inference_mode():
            want = model.network.inference(x)
        launches[pow_] = check_request(f"config_hash request at 2^{pow_}", model.trainer, x,
                                       want, t)
    btf = create_from_config(6, 3, BTF_CONFIG, policy=BF16_POLICY, seed=22)
    x6 = torch.rand((MAIN_BATCH, 6), generator=gen, device=dev)
    with torch.inference_mode():
        want = btf.network.inference(x6)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    btf_launches = check_request(f"config_btf request at 2^{MAIN_BATCH.bit_length() - 1}",
                                 btf.trainer, x6, want, t)
    pool = pool_mb(btf.trainer._request_pool)
    print(f"config_btf's request graph at B={MAIN_BATCH}: its memory pool holds "
          f"{'not measured' if pool is None else f'{pool:.1f} MB'} (memory_snapshot); the "
          f"card's reserved memory grew by "
          f"{(torch.cuda.memory_reserved() - reserved) / 2 ** 20:.1f} MB over the first "
          f"request and the timings")
    t["btf pool MB"] = pool

    phase(f"slice 22: EMA(Adam) at config_hash: a request after {EMA_REQUEST_STEPS} eager "
          f"steps, {EMA_REQUEST_STEPS} more, and the replayed request against the eager EMA "
          f"weights")
    base = load_config(CONFIG)
    ema = create_from_config(2, 3, {**base, "optimizer": {
        "otype": "EMA", "decay": EMA_DECAY, "nested": base["optimizer"]}},
        policy=BF16_POLICY, seed=22)
    sampler = ImageSampler(synthetic_image(1024, 1024), seed=22)
    x = torch.rand((MAIN_BATCH, 2), generator=gen, device=dev)

    def eager_ema():
        with torch.inference_mode():
            return torch.func.functional_call(ema.network, ema.trainer.inference_params(), (x,))

    for _ in range(EMA_REQUEST_STEPS):
        ema.trainer.training_step(*sampler.sample_batch(MAIN_BATCH))
    before = ema.trainer.inference(x)
    check(torch.equal(before, eager_ema()), "EMA: the first request differs from the eager one")
    for _ in range(EMA_REQUEST_STEPS):
        ema.trainer.training_step(*sampler.sample_batch(MAIN_BATCH))
    torch.cuda.synchronize()
    reset_counts()
    after = ema.trainer.inference(x)
    torch.cuda.synchronize()
    replay_launches = first_order_counts()
    want = eager_ema()
    with torch.inference_mode():
        raw = ema.network.inference(x)
    check(replay_launches == {"G": 0, "M": 0, "GB": 0, "MB": 0},
          f"EMA: the second request launched {replay_launches}: it must replay")
    check(torch.equal(after, want) and not torch.equal(after, before)
          and not torch.equal(after, raw),
          f"EMA: the replayed request after {EMA_REQUEST_STEPS} more steps is not the eager "
          f"EMA weights' answer (or equals the earlier one or the raw weights')")
    print(f"after {2 * EMA_REQUEST_STEPS} steps the replayed request equals the eager module "
          f"on the EMA weights bit for bit, and differs from the request after "
          f"{EMA_REQUEST_STEPS} (max abs {float((after - before).abs().max()):.3e}) and from the "
          f"raw weights' answer (max abs {float((after - raw).abs().max()):.3e})")

    phase("slice 22: Trainer.forward and evaluate_loss compiled, against the module and the "
          "loss")
    target = torch.rand((MAIN_BATCH, 3), generator=gen, device=dev)
    with torch.no_grad():
        want = model.network(x)
        want_loss = model.loss(want.float(), target)
    reset_counts()
    outs = [model.trainer.forward(x) for _ in range(2)]
    loss = model.trainer.evaluate_loss(x, target)
    torch.cuda.synchronize()
    fwd_launches = first_order_counts()
    check(fwd_launches == {"G": 2, "M": 2, "GB": 0, "MB": 0},
          f"forward launches {fwd_launches}: expected G and M twice (one capture)")
    check(all(torch.equal(o, want) and not o.is_inference() and not o.requires_grad
              for o in outs) and torch.equal(loss, want_loss),
          "forward or evaluate_loss differ from the module's")
    def eager_forward():
        with torch.no_grad():
            return model.network(x)

    t["forward"] = {"eager": time_ms(eager_forward),
                    "compiled": time_ms(lambda: model.trainer.forward(x))}
    print(f"forward twice and evaluate_loss: bit for bit the module's and the loss's; one "
          f"forward at 2^18 {t['forward']['eager']:.4f} ms eager, "
          f"{t['forward']['compiled']:.4f} ms compiled")

    phase(f"slice 22: DataParallel and HybridParallel (n_model 1) make_training_step and "
          f"make_inference on a one-rank NCCL group, config_hash at B={MAIN_BATCH}, "
          f"{NCCL_COMPILED_STEPS} steps")
    with tempfile.TemporaryDirectory() as tmp:
        res, = parallel_check.run_ranks(1, parallel_check.nccl_compiled_job,
                                        {"steps": NCCL_COMPILED_STEPS, "batch": MAIN_BATCH,
                                         "rounds": NCCL_COMPILED_ROUNDS},
                                        timeout=600, tmp=tmp, backend="nccl")
    check(res["backend"] == "nccl", f"the group's backend is {res['backend']}")
    sortseg_want = {"G": 2, "M": 2, "MB": 2, "SK": 2, "SS": 2}
    for kind, r in res["sortseg"].items():
        lc = r["launches"]
        check(r["same_as_eager"] and r["same_as_trainer"],
              f"{kind}: under sortseg the compiled steps differ from step_shard_map's eager "
              f"steps ({r['same_as_eager']}) or Trainer.make_training_step's "
              f"({r['same_as_trainer']})")
        check(all(lc[k] == sortseg_want.get(k, 0) for k in lc)
              and r["step"] == NCCL_COMPILED_STEPS and r["key_names_layer"],
              f"{kind}: launches {lc}, step {r['step']}, key names the layer "
              f"{r['key_names_layer']}; expected {sortseg_want} and no GB")
        il = r["inference_launches"]
        check(r["inference_equal"] and r["inference_is_inference"]
              and il["capture"]["G"] == il["capture"]["M"] == 2
              and not any(il["replay"].values()),
              f"{kind} make_inference: equal {r['inference_equal']}, launches {il}")
        print(f"{kind}: {NCCL_COMPILED_STEPS} compiled steps under sortseg equal as many "
              f"step_shard_map eager steps and Trainer.make_training_step's, bit for bit (losses "
              f"and weights); loss {r['losses'][0]:.6f} -> {r['losses'][-1]:.6f}; launches {lc}; "
              f"make_inference's replay equals the eager module bit for bit (launches at "
              f"capture G {il['capture']['G']}, M {il['capture']['M']}, none in the replay)")
    main = res["main"]
    got, want_l = np.asarray(main["losses"]), np.asarray(main["trainer_losses"])
    rtol = np.full(NCCL_COMPILED_STEPS, PARALLEL_LOSS_RTOL)
    rtol[0] = PARALLEL_FIRST_RTOL
    lc = main["launches"]
    check(bool(np.isfinite(got).all()) and got[-1] < got[0]
          and not (np.abs(got - want_l) > rtol * np.abs(want_l)).any(),
          f"DataParallel.make_training_step losses {got.tolist()} vs the trainer's "
          f"{want_l.tolist()}")
    check({k: lc[k] for k in FIRST_ORDER} == {"G": 2, "M": 2, "GB": 2, "MB": 2}
          and all(lc[k] == 0 for k in lc if k not in FIRST_ORDER),
          f"DataParallel.make_training_step launches {lc}: expected G, M, GB and MB twice")
    ms = {w: min(v) for w, v in res["ms"].items()}
    dms = res["device_ms"]
    t["parallel step"] = {"ms": ms, "device_ms": dms}
    print(f"DataParallel.make_training_step (the main path): loss {got[0]:.6f} -> "
          f"{got[-1]:.6f}, within {float(np.max(np.abs(got - want_l) / np.abs(want_l))):.3e} of "
          f"Trainer.make_training_step's; launches {lc}")
    print(f"ms per step on the host clock (passes of {NCCL_COMPILED_STEPS} steps, the least of "
          f"{NCCL_COMPILED_ROUNDS}, in turns): DataParallel.make_training_step "
          f"{ms['parallel']:.4f}, Trainer.make_training_step {ms['trainer']:.4f}, "
          f"step_shard_map eager {ms['eager']:.4f}; the replays on the device "
          f"{dms['parallel']:.4f} and {dms['trainer']:.4f} ms (idle shares "
          f"{1 - dms['parallel'] / ms['parallel']:.3f} and "
          f"{1 - dms['trainer'] / ms['trainer']:.3f}); all turns {res['ms']}")
    print(f"slice 22: {time.time() - t_start:.1f} s")
    first_order = set(KERNELS[k][0] for k in FIRST_ORDER)
    return (compiled_entries(hash_entries, lambda n: " (" not in n
                             and n.split(" (")[0] in ("grid_encode_fwd", "fused_mlp_fwd"),
                             launches[MAIN_BATCH.bit_length() - 1],
                             f"Trainer.inference, config_hash at 2^{MAIN_BATCH.bit_length() - 1}",
                             "slice 22", "request")
            + compiled_entries(btf_entries, lambda n: n.endswith(" (config_btf)")
                               and n.split(" (")[0] in ("grid_encode_fwd", "fused_mlp_fwd"),
                               btf_launches,
                               f"Trainer.inference, config_btf at 2^{MAIN_BATCH.bit_length() - 1}",
                               "slice 22", "request")
            + compiled_entries(hash_entries, lambda n: " (" not in n
                               and n.split(" (")[0] in first_order, lc,
                               "DataParallel.make_training_step, one NCCL rank", "slice 22"))


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    from tcnn_tpu_torch.ops.cuda import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    t_start = time.time()
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    phase("build")
    t0 = time.time()
    kernels()
    print(f"kernels built from tcnn_tpu_torch/csrc in {time.time() - t0:.1f} s")

    hash_entries, hash_times = config_hash_slices(gen, dev)
    btf_entries = config_btf_slice(gen, dev)
    oneblob_entries = config_oneblob_slice(gen, dev)
    sdf_entries = sdf_slice(gen, dev)
    nerf_entries = nerf_slice(gen, dev)
    report = {"kernels": hash_entries + btf_entries + oneblob_entries + sdf_entries + nerf_entries
              + save_load_serve_slice(gen, dev, hash_times) + bindings_slice(gen, dev)
              + rng_stochastic_slice(gen, dev, hash_times) + masked_sdf_slice(gen, dev)
              + wide_grid_slice(gen, dev) + deep_mlp_slice(gen, dev)
              + parallel_slice(gen, dev) + parallel_loop_slice(dev, hash_entries)
              + slice14(gen, dev, hash_times)
              + wide_features_slice(gen, dev) + wide_output_slice(gen, dev)
              + sortseg_slice(gen, dev)
              + compiled_step_slice(gen, dev, hash_entries, sdf_entries, nerf_entries)
              + compiled_requests_slice(gen, dev, hash_entries, btf_entries)
              + shampoo_slice(gen, dev)}
    torch_func_slice(gen, dev)
    image_sample_slice()
    mb_determinism(gen, dev)
    phase("kernels")
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all")
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
