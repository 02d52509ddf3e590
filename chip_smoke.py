#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (skirt9_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Drives config 1 of bench.py (point source, uniform dust sphere, forced
scattering, HG peel-off to one SED + 64x64 frame instrument) through the
port's Python API on two paths: the 32^3 grid of bench.py config 1 (resident
sweep, kernels 1-2) and the 256^3 grid of bench.py `bench_config1x256`
(large-grid XL sweep, kernels 6-7); then bench.py's clumpy-ISM site-list
octrees `bench_config3ism` and `bench_config3ismxl` (multi-level tree sweep,
kernels 4-5); then config 2 (bench2.ski: panchromatic dust emission,
kernels 1-2 with a 25-bin stratified RF); and the gather and row-lookup
probes (kernels 8-9, and kernel 3) through their own entry points; then
config 3 (bench3.ski through the port's own ski loader: a density octree,
a 25-bin RF in lane groups and dust self-absorption iterations, kernels
4-5), config 1h (bench1h.ski, lane refill) and the CLI on bench1.ski,
bench2.ski and bench3.ski; then config 2 at 256^3 (bench2.ski with its
meshes at 256 bins: the XL contracts with the 25-bin RF in lane groups) and
bench_config3ismxl's recipe at max_level 9 (a tree on its 512^3 voxel
raster through the XL contracts); then config 5 (bench5.ski: polarized
Thomson scattering in a 2000 km/s outflow, detect in its Stokes mode); last
configs 6 and 7 (bench6.ski: Lyman-alpha resonant line transfer at
line-centre optical depths up to 10^5; bench7.ski: X-ray gas with Compton
scattering and Fe K fluorescence); last config 4 (bench4.ski: 40 imported
SSP star particles and a 2,895-site Voronoi medium, rasterized onto 73^3
voxels for kernels 4-5); then an analytic galaxy of geometric sources on
the 2D cylinder and on an octree, and the Ivezic shell on the 1D sphere;
last the same galaxy as imported hydro snapshots: an adaptive mesh on the
tree sweep and under a 3 3 3 root on march_amr, and SPH gas and star
particles on a density octree.
Every path detects through the fused detect
kernel (csrc/detect.cu), which took kernel 3's place there. Each hand-written CUDA kernel is checked against
its plain PyTorch version.
Phases, one JSON line each:

  env               torch / CUDA / nvcc versions, the card, its power limit
  build             nvcc build of skirt9_tpu_torch/csrc/*.cu, one process per
                    source, all started together (cached by hash)
  kernels           at config-1 shapes (B = 131072, 32^3, C = 1), against
                    their plain versions, timed: kernel 1 in its three modes
                    (sweep_dtau bit-identical; sweep_tau_total and
                    sweep_dtau_prefix within 1e-6 of each lane's tau; the
                    lane range it forms equal to _lane_range bit for bit),
                    kernel 2 in its two modes (sweep_deposit on scale and
                    rel tables, sweep_deposit_prefix forming them from the
                    prefix: the same interactions bit for bit), kernel 3
                    (sizes 1 and 4096), and detect (one
                    bin, 64x64 frame) within 1e-5 of each accumulator's
                    maximum against the plain detect and the seven-call
                    form through kernel 3
  kernels_xl        kernels 6-7 vs their plain versions at 256^3, B = 131072,
                    C = 1, lanes sorted as the path sorts them: kernel 6's
                    record and summed form bit-identical, its total (the +z
                    peel-off) and prefix within 1e-6 of each lane's tau,
                    the lane range it forms equal to _lane_range bit for
                    bit; kernel 7's table mode, its RF within 1e-4 of its
                    maximum, and its prefix mode on kernel 6's prefix with
                    an RF, with lum_half = 0 and without an RF: s_int,
                    icell and found identical, the RF within 1e-4 of its
                    maximum; each mode timed, kernel 7's prefix mode beside
                    the parent's unfused form (scale_slab, the table mode,
                    resolve_interaction), kernel 6 also on unsorted lanes,
                    kernel 1 on the same rays, and the variants of
                    perf/kernel6_variants.py and perf/kernel7_variants.py
                    (other run lengths, other designs, the first designs,
                    splits)
  draw_for_draw     16,384 packets on the CPU (plain versions) and on the GPU
                    (kernels), same seed: SEDs within 1e-4, frame within 1e-3
                    of its brightest pixel; again with a one-bin RF, totals
                    1e-4
  draw_for_draw_xl  the same at 80^3, where the port picks the XL contracts
  full_width        config 1 at 2^20 packets in batches of 2^17, timed after a
                    warm-up: kernel 1's total and prefix modes, kernel 2's
                    prefix mode and detect launched; kernels 1 and 2 in
                    their reference modes, kernel 3 and kernels 6-7 not;
                    accumulators
                    finite, the transparent SED analytic within 1e-5,
                    direct/transparent = exp(-tau) within 1e-3, SED relative
                    error R < 0.01
  breakdown         host-sync and RNG shares of the timed run; one batch
                    under torch.profiler at event caps 24 and 2: device
                    launches, kernel launches, stream syncs and host-to-
                    device copies per event of the loop, busy and idle
                    shares
  full_width_xl     bench_config1x256 (256^3, 2^17 packets in one batch, 24
                    events, no RF), timed after a warm-up: the XL tables,
                    kernel 6's prefix and total modes, kernel 7's prefix
                    mode and detect launched, their reference modes and
                    kernels 1-5 not, the same gates
  rf_xl             the same with a one-bin RF: kernel 7's prefix mode
                    launched on pass 1's record, prefix and lane range, the
                    RF
                    finite and positive, its total within 1e-4 of the same
                    seed's run on the resident sweep (kernels 1-2)
  kernels_ml        kernels 4-5 (the multi-level tree sweep) vs their plain
                    versions through their public wrappers, B = 65536,
                    C = 1: kernel 4 on bench_config3ism's site-list octree
                    (a 128^3 fine raster) and on bench_config3ismxl's (256^3,
                    its leaf map beyond L2), with want_sub, summed and with
                    the +z peel-off hint, tau within 1e-5 relative
                    (bit-identical expected) and leaf ids identical, its
                    total (the +z peel-off and the event rays) and prefix
                    modes within 1e-6 of each lane's tau, their record,
                    leaf ids, step sums and lane range bit for bit; kernel
                    5 on both trees (config3ism's in its shared-memory leaf
                    table, config3ismxl's on its global path), its RF within
                    1e-5 of its maximum, s_int, found and the interaction
                    cells equal; timed, kernel 4's modes beside the unfused
                    forms the parent's loop ran and the variants of
                    perf/kernel4_variants.py (run lengths, the first
                    design, a split), resolve_interaction (the no-RF pass
                    2) as the parent called it and with pass 1's lane range
                    and step sums beside kernel 5
  draw_for_draw_ml  the density octree of tests/test_mlsweep.py (max_level
                    4) with a one-bin RF, 16,384 packets, CPU vs GPU: SEDs
                    within 1e-4, frame 1e-3 of its brightest pixel, RF total
                    1e-4
  full_width_ml     bench_config3ism (bench.py:317-367: 46 x 26 sites,
                    max_level 7, about 5,000 leaves, 2^17 packets in batches
                    of 2^16, 16 events, no RF), timed after a warm-up:
                    kernel 4's total and prefix modes and detect launched,
                    its reference modes and no uniform-grid sweep; the
                    transparent SED analytic within 1e-5, direct/transparent
                    = exp(-0.5) within 1e-3, R < 0.01
  full_width_ml_large  bench_config3ismxl's tree (bench.py:370-420: 400 x 96
                    sites, max_level 8, about 1.4e5 leaves on a 256^3 fine
                    raster), the same run and gates; the reference sends
                    this tree to its XL fine raster, the port's rule to
                    kernels 4-5
  breakdown_ml      one more full_width_ml run under torch.profiler: device
                    launches, stream syncs and host-to-device copies per
                    event, busy and idle shares, top kernels
  rf_ml             full_width_ml with a one-bin RF: kernel 5 launched too,
                    the RF finite and positive, packets/s against
                    full_width_ml
  kernels_probe     kernels 8-9 through their entry points
                    (skirt9_tpu_torch/tools/gather_probe.py, sublane_gather.py)
                    at the original probes' shapes, each variant against its
                    plain version (gathers and the row lookups bit-exact,
                    sums 1e-6 relative), timed with the plain and library
                    times and kernel 3 at the probe's scatter shape; the
                    parent's designs and the variants of
                    perf/kernel8_variants.py and perf/kernel9_variants.py
                    timed in turns with the package's kernels, the launch
                    floor, the rates of distributed shared memory and the
                    host cost of a per-call launch set-up
  kernels_b2        kernel 2 in both modes with config 2's 32 lane groups
                    (the prefix mode folding them into the 25 bins by the
                    launch's bin map), kernel 3 on its
                    163,840-bin frame and detect (40 bins, 40x64x64 frame),
                    on config 2's first event, against their plain versions
                    (RF 1e-4 of its maximum, sums 1e-5)
  draw_for_draw_b2  config 2 at 8^3 (8,192 packets, 8 events, one
                    self-absorption iteration), CPU vs GPU: SEDs and RF
                    within 1e-4 of their maxima, L_dust 1e-4
  full_width_b2     bench2.ski (bench.py:79-105) built through the port's API
                    at full width, 2^20 packets in batches of 2^17, timed after
                    a warm-up: packets/s as bench.py counts them, seconds and
                    events per segment; bench2's golden gates
                    (tests/test_reference_parity.py:72-141) and L_dust =
                    L_abs_primary within 1e-4
  breakdown_b2      config 2 with one batch per segment under torch.profiler,
                    as breakdown
  kernels_b3        kernel 5's grouped mode on config 3's first event (the
                    full bench3 tree, 55,574 leaves, its global path; 32
                    lane groups of a 2^16 batch folded into the 25 RF rows
                    by the launch's bin map) against its plain version: RF
                    within 1e-6 of its maximum, s_int, icell and found
                    equal; timed by CUDA events and device time, with its
                    bound and the plain version's time
  draw_for_draw_b3  the reduced config 3 (bench3.ski at maxLevel 4, 8,192
                    packets, 4 events, at most 2 iterations), CPU vs GPU:
                    iterations equal, SEDs and RF within 2e-5 of their
                    maxima, frame 1e-3 of its brightest pixel, L_dust 1e-4;
                    kernels 4-5 and detect launched, no other sweep
  full_width_b3     bench3.ski (bench.py:130-149) through the port's
                    load_ski at bench_config3's 2^18 packets in batches of
                    2^16, 24 events, timed after a warm-up: packets/s as
                    bench.py counts them, seconds and events per segment,
                    iterations, L_dust against L_abs_primary; kernels 4-5
                    and detect launched, kernels 1, 2, 6 and 7 not; every
                    gate of test_bench3_* (tests/test_reference_parity.py:
                    185-269)
  breakdown_b3      config 3 with one batch per segment under
                    torch.profiler, as breakdown
  refill_b1h        config 1h (bench.py:108-126): tests/golden/bench1h.ski
                    through the port's load_ski, 2^19 packets in batches of
                    2^17, in lane-refill generations of 16 events, timed
                    after a warm-up: kernels 1-2 and detect launched, no
                    lane abandoned at the generation cap, bench1h's golden
                    gates (tests/test_reference_parity.py:149-178);
                    packets/s, generations, events and host syncs per
                    generation; kernel 1's total and prefix modes, kernel
                    2's prefix mode and detect on a refilled batch (dead,
                    fresh and old lanes side by side) against their plain
                    versions; one batch profiled as breakdown (idle share)
  cli               the port's CLI (skirt9_tpu_torch.__main__.main) on
                    bench1.ski, bench2.ski and bench4.ski at their 10^6
                    packets and
                    bench3.ski at 2^18 (-p), -b 131072, into a temporary
                    directory, bench5.ski and its static copy at
                    their 2 x 10^6, bench6.ski at its 10^5 (128 events,
                    --max-events) and bench7.ski at its 10^6: kernels 1-2
                    and detect launched (kernels 4-5 for bench3); wall
                    time each; the gates
                    read back from the written files (bench5's SED and
                    Stokes cubes: bench5_gates; bench1's SED against
                    tests/test_reference_parity.py:26-49, bench2's and
                    bench3's SED, RF and dust temperature probe files
                    against their golden gates; bench4's SED and
                    temperature files against bench4_gates), the probe
                    files one row per cell, equal to the run's RF and dust
                    temperature, and bench3's and bench4's cell-properties
                    files their volumes and densities; bench6's and
                    bench7's SEDs through b67_file_gates (bench6's highest
                    peak reported)
  kernels_xl_grouped  kernel 7's prefix mode with lane groups on config 2's
                    first event at 256^3 (B = 131,072, 32 groups folded
                    into the 25 RF rows by the launch's bin map) against
                    its plain version: RF within 1e-6 of its maximum,
                    s_int, icell and found identical; timed adding into an
                    accumulator (the path's form) and into a fresh zero
                    table, with its bound and the plain version's time
  kernels_treexl    bench_config3ismxl's recipe at max_level 9 (143,536
                    leaves, a 512^3 voxel raster) with a one-bin RF, its
                    first event: kernel 6's prefix mode at nmax = 512
                    (record and lane range bit for bit, prefix and total
                    within 1e-6 of each lane's tau) and kernel 7 with the
                    cell map (as kernels_xl_grouped), timed
  draw_for_draw_xl_b2  config 2 at 80^3 (XL, an 8-bin RF in 8 lane
                    groups, 16,384 packets, one self-absorption iteration),
                    CPU vs GPU: the primary segment's RF and SEDs within
                    2e-5, frame 1e-3; the dust emission run's L_dust
                    1e-4, its RF bins and SED kinds by their sums 1e-3
  full_width_b2x256 bench2.ski through load_ski with its meshes at 256 bins
                    (16.8 M cells, XL; 2^20 packets in batches of 2^17, 24
                    events), timed after a one-batch warm-up: kernels 6-7
                    and detect launched, no resident or tree kernel;
                    L_dust = L_abs_primary within 1e-4; packets/s, seconds
                    per segment, the emission layer timed apart, bench2's
                    golden ratios on the RF and temperature averaged onto
                    the goldens' 32^3 cells (reported)
  rf_xl_b2x256      its primary segment against the same seed on the
                    resident sweep put in place: RF totals within 1e-4
  full_width_treexl the level-9 tree at bench_config3ismxl's 2^17 packets
                    in batches of 2^16, 16 events, no RF: the XL tables
                    with the cell map, kernels 6-7 and detect launched, no
                    multi-level kernel; full_width_ml's gates
  rf_treexl         the same with a one-bin RF, per leaf, finite, positive
  treexl_vs_ml      bench_config3ismxl's level-8 tree on its voxel raster
                    (the XL tables put in place) against the multi-level
                    sweep, the same seed, a one-bin RF: SEDs and RF totals
                    within 1e-3
  kernels_b5        detect's Stokes mode at config 5's first scattering
                    peel-off (B = 131,072, 40 bins, a 40x64x64 frame and
                    its three Stokes cubes) against the plain version's
                    terms summed exactly: every accumulator within 1e-5 of
                    its largest |value|, V identically 0; timed, its bound
                    (33 bytes a lane and the entries reached)
  draw_for_draw_b5  bench5.ski at 16^3 (16,384 packets, 8 events), moving
                    and static, CPU vs GPU: the unpolarized light within
                    1e-5 of each accumulator's maximum, the scattered light
                    and the Stokes sums within B5_BOUNDS (the reference's
                    polarized azimuth is chaotic to an ulp)
  full_width_b5     bench5.ski (bench.py:175-193) through load_ski at 2^20
                    packets in batches of 2^17, 24 events, timed after a
                    warm-up: kernels 1-2 and detect launched; the static
                    variant at the same width; every gate of the bench5
                    golden tests (tests/test_reference_parity.py:280-353)
                    on the written files, the frame gates of
                    tests/test_frame_parity.py:99-123 at that test's width
  breakdown_b5      one batch of config 5 under torch.profiler, as
                    breakdown
  kernels_b6        kernels 1, 2 and detect at config 6's first scattering
                    event (B = 65,536; path depths up to ~1e5; cross
                    sections per lane; detection wavelengths per lane,
                    some outside the 75-bin grid) against their plain
                    versions (check_kernels_b6): lane range, found and
                    icell identical, tau within 1e-6 of each lane's tau,
                    s_int within 1e-5 of a cell, detect within 1e-5 of each
                    maximum; timed, with bounds
  draw_for_draw_b6  the reduced configs 6 and 7 (B67_SMALL: 4,096 packets,
  draw_for_draw_b7  12 and 16 events), CPU vs GPU: each SED row within
                    B6_BOUNDS or B7_BOUNDS of its maximum (stated with
                    their reasons); kernels 1-2 and detect launched
  full_width_b6     bench6.ski (bench.py:196-212: 2^17 packets in batches of
                    2^16, 128 events) through load_ski, timed after a
                    one-batch warm-up: kernels 1-2 and detect launched,
                    kernels 4-7 not; every gate of
                    test_bench6_lya_profile_parity (tests/
                    test_reference_parity.py:477-506) on the written SED,
                    the highest peak's bin reported (the golden's two peaks
                    differ by 0.5%), and every gate with it at the test's
                    own width (B6_TEST: 20,000 packets)
  full_width_b7     bench7.ski (bench.py:215-231: 2^18 packets in batches of
                    2^16, 16 events), likewise, every gate of
                    test_bench7_xray_parity (:528-566)
  breakdown_b6      one batch of config 6 under torch.profiler, as
                    breakdown (the Lya loop's operations per event)
  kernels_b4        kernels 4-5 and detect at config 4's first event (B =
                    65,536 star-particle lanes in 32 groups on the 73^3
                    raster of the 2,895 Voronoi cells, a 73-step plan):
                    kernel 4's prefix mode on the event rays and its total
                    mode toward the instrument (lane range and leaf ids
                    identical, record, step sums, prefix and totals within
                    1e-6 of each lane's tau), kernel 5's grouped mode into
                    the 25 RF rows (RF within 1e-6 of its maximum, s_int,
                    icell and found identical) and detect, each against its
                    plain version; timed, with bounds
  draw_for_draw_b4  the reduced config 4 (B4_SMALL: 8,192 packets, 4
                    events, the 73^3 raster), CPU vs GPU within B4_BOUNDS:
                    the primary light and RF draw for draw, the secondary
                    light by its sums (the secondary launch's cell cdf);
                    kernels 4-5 and detect launched, no other sweep
  full_width_b4     bench4.ski (bench.py:152-172: 2^19 packets in batches
                    of 2^16, 24 events) through load_ski, timed after a
                    warm-up: packets/s as bench.py counts them, seconds and
                    events per segment, the host set-up (Voronoi build,
                    raster); kernels 4-5 and detect launched, kernels 1, 2,
                    6 and 7 not; every gate of test_bench4_* (tests/
                    test_reference_parity.py:376-458: bench4_gates), and
                    the same gates at that test's own width (B4_TEST: 10^5
                    packets in batches of 8,192, 16 events), reported
  breakdown_b4      one batch of config 4 per segment under torch.profiler,
                    as breakdown
  kernels_march     (right after build, in a fresh process's profiler) the
                    scan march kernel (csrc/march.cu) against its plain
                    version on the card in its three modes: march_voronoi
                    at bench4's first event (2^16 lanes, S = 76, the
                    2,895-site grid), march_uniform on config 1's 32^3 grid
                    and march_mesh on a 32^3 SymPowMesh copy of it (2^17
                    lanes, S = 99); cells equal on every (step, lane) pair
                    (or at most 1e-4 of the lanes differing, counted), each
                    lane's summed length within 1e-6; kernel ms by CUDA
                    events, device ms by the profiler (checked for a
                    dropped kernel), the bound from the bytes written and
                    read
  draw_for_draw_march  the reduced configurations of tests/
                    test_torch_config_march.py (MARCH_SMALL) on the CPU and
                    on the card: SEDs and RF within 2e-5 of their maxima
                    (a one-bin SED 1e-4), after dust emission the
                    secondary light by its sums (1e-3), bench6 within
                    B6_BOUNDS, bench7 within B7_BOUNDS, the polarized
                    bench5 within B5_BOUNDS; the Cartesian and Voronoi
                    cases march without sweep tables, the trees take the
                    engine chain's: bench3 at maxLevel 4 with explicit
                    absorption, a 4-bin RF and one self-absorption
                    iteration (the octree march; also on a bintree),
                    bench5 on an octree moving (polarization and
                    kinematics on the tree's XL raster) and static
                    (polarization on the tree sweep), bench6 on an octree
                    with its gas temperature rising 1x to 2x (Lya on the
                    tree march) and bench7 on an octree (X-ray on the XL
                    raster); each case's kernels and detect launched, no
                    other march mode or sweep
  full_width_b4_walk  bench4.ski at bench_config4's width with
                    raster_fallback off: the exact Voronoi walk, every
                    bench4 gate strict, march_voronoi and detect launched,
                    kernels 4-5 not; packets/s, events, the loop's device
                    operations, syncs and host copies per event and the
                    idle share; the SED and per-cell T beside full_width_b4's
                    raster run (the raster's chord error, not gated)
  full_width_b1_march  config 1 at 2^20 packets with explicit absorption
                    (march_uniform: config 1's gates) and on a 32^3
                    SymPowMesh grid (march_mesh: the transparent SED exact,
                    the scattered SED within 2% of full_width's sweep run),
                    packets/s beside full_width's
  kernels_march_tree  (right after kernels_march) the march kernel's tree
                    modes against their plain versions on the card:
                    march_octree on bench3's octree (55,574 leaves, 2^16
                    lanes at its first event, S = 256), march_bintree on
                    bench3 with treeType="BinTree" (the loader's triple
                    levels) and march_octree on a level-10 octree (2^16
                    random lanes); cells identical and lengths
                    bit-identical on every (step, lane) (_march_check),
                    timed, the bound from the bytes of the (S, B) tables
  full_width_b3_march  bench3.ski with explicitAbsorption at bench_config3's
                    width (2^18 packets in batches of 2^16, 24 events): the
                    raster's XL tables built and declined by the gate,
                    march_octree and detect launched, no sweep kernel; every
                    bench3 gate; packets/s beside full_width_b3's tree-sweep
                    run and its gates; one batch per segment profiled
  kernels_b5_tree   (right after kernels_march_tree) kernel 6's prefix
                    and total modes and kernel 7's prefix mode without an
                    RF against their plain versions at full_width_b5_tree's
                    first event (2^17 lanes, the 64^3 tree raster), timed,
                    with bounds
  full_width_b5_tree  bench5.ski on a maxLevel-6 density octree (24,571
                    leaves, its 64^3 voxel raster) at bench_config5's width:
                    kernels 6-7 and detect's Stokes mode, no march; gated (point_source_gates): the transparent
                    SED against the blackbody integrated over each bin
                    (within 5 sigma of the run's sampling noise per bin and
                    in total), the direct SED over the transparent one
                    equal to exp(-tau) of the line of sight through the
                    tree's leaves (1e-4), V identically 0, R < 0.01;
                    bench5's golden ratios beside full_width_b5's, reported
  kernels_march_curvi  (right after kernels_march_tree) the march kernel's
                    curvilinear modes bit for bit against their plain
                    versions: march_cylinder2d at disk_cyl's first event
                    (2^16 lanes of its stellar disk, a 128 x 128 cylinder
                    to 25 kpc, shift 10, S = 256) and march_sphere1d at the
                    Ivezic setup's (40 shells), both also on seeded rays
                    from inside and outside linear-mesh grids; timed, the
                    bound from the bytes of the (S, B) tables
  draw_for_draw_geometric  the generated reduced configurations of
                    MARCH_SMALL (GEO_CASES) on the CPU and on the card
                    within MARCH_BOUNDS: the galaxy (an exponential disk
                    and a flattened Sersic bulge in a dust disk) on a 16 x
                    16 cylinder (march_cylinder2d), on a 16^3 uniform grid
                    (kernels 1-2) and on a maxLevel-4 octree with a spiral
                    dust disk (kernels 4-5), the Ivezic shell on a 40-shell
                    sphere (march_sphere1d), a combined, rotated and
                    clipped source on the cylinder
  full_width_disk_cyl  disk_cyl (galaxy_ski: 2^20 packets in batches of
                    2^16, 24 events, an 8-bin RF, two instruments of 40
                    bins and 128 x 128 pixels) on its 128 x 128 cylinder:
                    march_cylinder2d and detect launched, nothing else;
                    gated: the transparent SED against the two blackbodies
                    per bin and in total within 5 sigma of the sampling
                    noise (blackbody_mix_gates), R < 0.01, 2^22 positions
                    of each source against its cell masses (chi-square
                    within 5 sigma, sampling_gates), and the face-on direct
                    over transparent light of a central point source in
                    the disk (disk_cyl_point) and of the Ivezic shell on
                    the 1D sphere against exp(-tau) of the host's column
                    (1e-3, direct_gate); packets/s, operations, syncs and
                    host copies per event and the idle share of one
                    profiled batch
  full_width_disk_tree  the same galaxy with a spiral dust disk on a
                    density octree (maxLevel 8): kernels 4-5 and detect on
                    the tree sweep, the transparent SED and R gates
  kernels_march_amr  (right after kernels_march_curvi) the march kernel's
                    adaptive-mesh mode bit for bit against its plain
                    version: tests/test_amr.py's two-level and 3 3 3 /
                    2 2 2 / 2 1 2 meshes (2^16 random lanes) and
                    amr_galaxy_march's mesh at its first event (2^16
                    lanes, S = its max_steps), timed, the bound from the
                    bytes of the (S, B) tables
  kernels_amr       (right after kernels_b5_tree) kernels 4-5 at
                    amr_galaxy's first event (kernel 4's prefix and total
                    modes, kernel 5 grouped into the 25 RF rows) on the
                    tree sweep's 256^3 raster, kernels 6-7 on the same
                    mesh's voxel raster (kernel 6's prefix mode, kernel 7
                    grouped through the cell map), against their plain
                    versions, timed; one batch through the XL engine there
  draw_for_draw_imports  the reduced snapshot configurations of SNAPSHOTS
                    on the CPU and on the card within MARCH_BOUNDS and
                    L_dust 1e-4: amr_galaxy_small (the tree sweep, dust
                    emission), amr_galaxy_march_small (march_amr),
                    sph_galaxy_small (an SPH octree, dust emission)
  full_width_amr    amr_galaxy (snapshot_ski: a RAMSES-style Morton file
                    of GALAXY's clumpy dust disk, a 2 2 2 root refined to
                    level 8, ~10^5 leaves, its star-forming leaves an
                    AdaptiveMeshSource of bench4's SSP family; dust
                    emission, a 25-bin RF; 2^20 packets in batches of
                    2^16, 24 events) on the tree sweep: kernels 4-5 and
                    detect; gated: the dust on the grid against the
                    file's (1e-6), L_dust = L_abs_primary (1e-4), tau
                    through the tree sweep against march_amr (tau_gate);
                    one batch profiled
  full_width_amr_march  the same file's leaves under a 3 3 3 root
                    (ExtinctionOnly, march_amr): 2^22 launch positions
                    over the leaves against their luminosity cdf (3
                    sigma), a primary run's transparent SED against the
                    leaves' luminosities (5 sigma)
  full_width_sph    sph_galaxy: 10^5 gas particles (ParticleMedium) on a
                    density octree of maxLevel 8 and 2x10^4 star
                    particles (ParticleSource, SSP family), dust emission
                    on the tree sweep; the set-up seconds; gated: the
                    resampled dust against the particles' (5%), L_dust
                    (1e-4), the star launches' particles and kernel radii
                    (3 sigma), the transparent SED (5 sigma)
  dd                spatial domain decomposition: configs 1 and 2 (32^3,
                    2^18 and 2^16 packets, their RF stored, config 2 with
                    dust emission and one iteration) on two ranks sharing
                    cuda:0 over gloo, each slab marched by march_uniform
                    (bit for bit against its plain version at the first
                    event's gathered lanes), against one process on the
                    march route within DD_BOUNDS; packets/s of both, host
                    round trips per event (config 1 held on the march
                    route by dd_segment(xl_local=None): on the card its one
                    RF bin takes the XL route)
  dd_xl             domain decomposition on the XL route: config 1 at 256^3
                    (the full_width_xl grid, its one-bin RF stored, 2^16
                    packets) on two ranks sharing cuda:0, each slab on
                    kernel 6 (want_sub, summed) and kernel 7
                    (sweep_deposit), held against their plain versions on
                    the path's own first event; against one process on the
                    XL route and the two ranks on the march route
                    (dd_segment(xl_local=None)) within 1e-3 of each maximum
                    (RF, SEDs, frame sums); packets/s of both routes, host
                    round trips per event
  local_instruments config 1 (32^3, 2^17 packets) with its distant
                    instrument and three local ones inside the sphere
                    (Mollweide all-sky, HEALPix, perspective): the source's
                    direct flux in each map against L e^-tau / (4 pi d^2)
                    (tau from the plain march), the perspective's source on
                    the crosshair's pixel, each map against the CPU's run
                    within 1e-4 of its maximum; kernel 3 (scatter_add) at
                    the first scattering peel-off against scatter_add_plain
                    and the f64 sum, timed beside index_add_; config 2 at
                    2^16 packets with dust emission: the maps' secondary
                    kinds

Each path is driven with the launch counts set to 0 just before it and read
just after; it names the kernels it must launch and those it must not. Then
the kernel summary line (each kernel's launches on its path, its error and
time against the plain version, its bound from this run's inputs and, where
one PyTorch call computes the same function, that call's time), the
nvidia-smi name/power line, and last {"ok": true, "device": {...}}. Any
failed check raises and the script exits non-zero without that line; so
does a machine without CUDA.
"""

from __future__ import annotations

import gzip
import json
import math
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

PC = 3.0857e16
B_FULL = 1 << 17
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
B_ML = 1 << 16            # bench_config3ism's batch
B_B3 = 1 << 16            # bench_config3's batch (bench.py:130-149)

# the H100 SXM's published peaks (NVIDIA's datasheet, at 700 W): HBM
# bytes/s and f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per active (slab or plan step, lane) thread, counted in
# csrc/sweep_common.cuh: entering the slab (29), one sub-step of the minor
# DDA (14), the opacity of C components (2C), a deposit's contribution with
# its segment factor and the interaction test (12); per lane, the set-up
# inside kernel 1 (csrc/sweep_dtau.cu lane_range and slab_range, 80), and
# per lane the detect kernel's bin search, powers and projection (40)
OPS_SLAB, OPS_SUB, OPS_DEP = 29, 14, 12
OPS_LANE, OPS_DETECT = 80, 40


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries the seconds since the
    script started (at_s)."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def config1(device, num_packets=1 << 20, batch_size=B_FULL, n=32,
            store_rf=False, npix=64, meshes=None, **options):
    """Config 1 of bench.py (bench.py:39-76) through the port's API. meshes:
    per-axis borders of a meshed Cartesian grid (the scan march); options:
    further TransportOptions (explicit_absorption)."""
    from skirt9_tpu_torch.grids.cartesian import make_cartesian
    from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.simulation import Simulation
    from skirt9_tpu_torch.sources.base import PointSource
    from skirt9_tpu_torch.transport.lifecycle import TransportOptions

    R = PC
    box = 1.2 * R
    grid = make_cartesian(((-box, box),) * 3, (n,) * 3, meshes=meshes)
    sigma = 1e-24
    nd = msys.uniform_density_sphere(grid, 1.0, sigma, R)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.array([[sigma, sigma]]),
                           albedo=np.full((1, 2), 0.6),
                           g=np.full((1, 2), 0.5))
    inst = DistantInstrumentCfg(name="i0", wave_borders=(0.5e-6, 0.6e-6),
                                distance=100 * PC, npx=npix, npy=npix,
                                fovx=4 * PC, fovy=4 * PC)
    opts = TransportOptions(max_steps=grid.max_steps(), max_events=24,
                            store_rf=store_rf, **options)
    return Simulation(grid=grid, medium=med,
                      sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                      instruments=[inst], options=opts,
                      rf_borders=(np.array([0.5e-6, 0.6e-6]) if store_rf
                                  else None),
                      num_packets=num_packets, batch_size=batch_size, seed=0,
                      device=device)


def config2(device, num_packets=1 << 20, batch_size=B_FULL, n=32, n_rf=25,
            max_events=24, iterate_secondary=False, max_iterations=10):
    """bench2.ski (tests/golden/bench2.ski, run by bench.py:79-105) through
    the port's API, with the arrays `load_ski` builds from it: a 5778 K
    blackbody point source of 1e5 Lsun clipped to 0.09-100 micron
    (wavelength bias 0.5), the MRN mean dust mix of mrn_mean.txt in a shell
    (1e-6 to 1 pc, flat profile) normalised to tau = 2 along z at 0.55
    micron, a uniform n^3 grid over +-1.2 pc, an n_rf-bin log RF grid over
    0.09-100 micron, a 40-bin log emission grid over 1-2000 micron, and one
    distant instrument at 100 pc: a 40-bin log SED over 0.09-1000 micron
    with statistics and a 64x64 frame of 4 pc. Equilibrium emission over
    all cells; by default no self-absorption iterations, as the ski file
    says. n, n_rf, max_events and the iteration options cut it down for
    small runs."""
    from skirt9_tpu_torch.grids.cartesian import make_cartesian
    from skirt9_tpu_torch.geometries.analytic import ShellGeometry
    from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
    from skirt9_tpu_torch.media import geometric as gm
    from skirt9_tpu_torch.media import mixes as mx
    from skirt9_tpu_torch.simulation import Simulation
    from skirt9_tpu_torch.sources.base import PointSource
    from skirt9_tpu_torch.spectral import seds
    from skirt9_tpu_torch.spectral import wavelengths as wl
    from skirt9_tpu_torch.transport.lifecycle import TransportOptions
    from skirt9_tpu_torch.utils import constants as c

    um, pc = 1e-6, c.PARSEC
    src_range = (0.09 * um, 100 * um)
    sed = seds.clipped(seds.blackbody(5778.0), *src_range)
    source = PointSource(position=(0.0, 0.0, 0.0),
                         luminosity=1e5 * c.SOLAR_LUMINOSITY, sed=sed,
                         wavelength_bias=0.5)
    grid = make_cartesian(((-1.2 * pc, 1.2 * pc),) * 3, (n,) * 3)
    medium = gm.build_medium(grid, [(
        ShellGeometry(rmin=1e-6 * pc, rmax=1 * pc, p=0.0),
        mx.from_file(os.path.join(GOLDEN, "mrn_mean.txt")),
        gm.OpticalDepthNormalization(tau=2.0, lam=0.55 * um, axis="z"))])
    inst = DistantInstrumentCfg(
        name="i0", wave_borders=tuple(wl.log_borders_skirt(0.09 * um,
                                                           1000 * um, 40)),
        distance=100 * pc, npx=64, npy=64, fovx=4 * pc, fovy=4 * pc)
    opts = TransportOptions(max_steps=min(grid.max_steps(), 256),
                            max_events=max_events, store_rf=True)
    return Simulation(
        grid=grid, medium=medium, sources=[source], instruments=[inst],
        options=opts, rf_borders=wl.log_borders_skirt(*src_range, n_rf),
        ems_borders=wl.log_borders_skirt(1 * um, 2000 * um, 40),
        num_packets=num_packets, batch_size=batch_size, seed=0,
        iterate_secondary=iterate_secondary, max_iterations=max_iterations,
        device=device)


def one_batch(sim, run) -> None:
    """A warm-up of one batch (run(verbose=False) with the simulation's
    packets cut to its batch and its events to 8: the kernels loaded, the
    tables and the allocator's blocks built), its packet count and options
    restored."""
    import dataclasses
    n, opts = sim.num_packets, sim.options
    sim.num_packets = sim.batch_size
    sim.options = dataclasses.replace(opts, max_events=min(opts.max_events,
                                                           8))
    try:
        run(verbose=False)
    finally:
        sim.num_packets, sim.options = n, opts


def drive(must: tuple, must_not: tuple, fn):
    """Run one path with the launch counts set to 0 just before it and read
    just after; require every kernel in `must` launched and none in
    `must_not`. Returns (fn's result, the counts)."""
    from skirt9_tpu_torch.kernels import build as kb
    kb.reset_launches()
    out = fn()
    launches = dict(kb.LAUNCHES)
    for name in must:
        require(launches[name] > 0,
                f"kernel {name} launched on the path ({launches[name]})")
    for name in must_not:
        require(launches[name] == 0,
                f"kernel {name} not launched on the path ({launches[name]})")
    return out, launches


def sphere_rays(torch, sim, rs, B):
    """B packets inside the dust sphere with isotropic directions, as events
    see them: pos, dir (B, 3), cross sections (1, B), in-grid mask."""
    r = PC * rs.uniform(size=B) ** (1.0 / 3.0)
    u = rs.normal(size=(B, 3))
    pos = (u / np.linalg.norm(u, axis=1, keepdims=True)) * r[:, None]
    d = rs.normal(size=(B, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=sim.device)
    pos, dirn = t32(pos), t32(d)
    sig = torch.full((1, B), 1e-24, dtype=torch.float32, device=sim.device)
    return pos, dirn, sig, sim.grid.locate(pos) >= 0


def cuda_ms(fn, reps: int = 20, warmup: int | None = None) -> float:
    """Mean device time of fn() in ms over reps back-to-back calls after
    warmup calls (3, or 1 for the few reps of a slow plain version)."""
    import torch
    for _ in range(warmup if warmup is not None else 3 if reps > 5 else 1):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> dict:
    """Device time per call of fn() from torch.profiler over reps calls
    after three warm-up calls: of the port's own kernels ("ours", named
    skirt9::) and of every kernel the call launches ("all"), and the device
    launches per call ("launches"). Beside the CUDA-event time of
    `cuda_ms`, which for a short kernel measures the host's launch rate,
    this is the time the card spent."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    total = lambda es: sum(e.self_device_time_total for e in es) / 1e3 / reps
    return {"ours": total([e for e in ev if "skirt9::" in e.key]),
            "all": total(ev), "launches": sum(e.count for e in ev) / reps}


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the HBM rate and
    the f32 operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def lane_bytes(B: int, C: int) -> int:
    """Per-lane inputs of a sweep kernel: pos, dir, axis, smin, smax, sig."""
    return B * (12 + 12 + 4 + 4 + 4 + 4 * C)


def ray_bytes(B: int, C: int) -> int:
    """Per-lane inputs of kernel 1, which forms the lane set-up itself: pos,
    dir, active (one byte), sig."""
    return B * (12 + 12 + 1 + 4 * C)


def scatter_f64(idx, val, size: int):
    """The plain scatter-add summed in float64, rounded once to float32:
    the exact sums of the plain detect's float32 terms."""
    import torch
    out = torch.zeros(size, dtype=torch.float64, device=val.device)
    return out.index_add_(0, idx.reshape(-1).long(),
                          val.reshape(-1).double()).float()


def check_detect(torch, cfg, tabs, lam, pos, contrib, active, kind,
                 quv=None) -> dict:
    """The detect kernel and the seven-call form (kernel 3 seven times, ten
    with Stokes) against the exact sums of the plain detect's terms
    (scatter_f64), on the same CUDA tensors, from zeroed accumulators:
    every accumulator within 1e-5 of its maximum, one kernel launch per
    call. With quv (B, 3) the Stokes mode: the Stokes accumulators too, and
    whether the kernel's V sums are identically 0 (`stokes_v_zero`). The
    plain detect's own float32 index_add_ is reported beside them: with
    131,072 lanes in one bin its sequential atomics stray ~5e-5. Then each
    form's time per call, device time and device launches per call, and
    the kernel's bound (inputs read once, each accumulator entry that this
    call's lanes reach read and written once)."""
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.kernels import build as kb
    from skirt9_tpu_torch.ops import scatteradd as sca
    dev = lam.device
    args = (lam, pos, contrib, kind, active)
    forms = {
        "kernel": lambda acc: dinst.detect(cfg, tabs, acc, *args,
                                           stokes_quv=quv),
        "plain": lambda acc: dinst.detect_plain(cfg, tabs, acc, *args,
                                                stokes_quv=quv),
        "seven": lambda acc: dinst.detect_plain(cfg, tabs, acc, *args,
                                                scatter=sca.scatter_add,
                                                stokes_quv=quv)}
    accs = {}
    for name, fn in forms.items():
        kb.reset_launches()
        accs[name] = fn(dinst.init_accumulators(cfg, dev))
        if name == "kernel":
            require(kb.LAUNCHES["detect"] == 1
                    and sum(kb.LAUNCHES.values()) == 1,
                    "detect: one kernel launch per call")
    exact = dinst.detect_plain(cfg, tabs, dinst.init_accumulators(cfg, dev),
                               *args, scatter=scatter_f64, stokes_quv=quv)
    torch.cuda.synchronize()
    err, rel = {}, {}
    for key, ref in exact.items():
        m = float(ref.abs().max())
        require(m > 0, f"detect test lanes light the {key}")
        for name in forms:
            e = float((accs[name][key] - ref).abs().max())
            err[f"{name}_{key}"] = e
            rel[f"{name}_{key}"] = e / m
            if name != "plain":
                require(e <= 1e-5 * m,
                        f"detect ({name}) {key} error {e} <= 1e-5 * {m}")
    acc = dinst.init_accumulators(cfg, dev)
    ms = {name: cuda_ms(lambda: fn(acc)) for name, fn in forms.items()}
    dev_t = {name: device_ms(lambda: fn(acc)) for name, fn in forms.items()}
    B, nb = lam.shape[0], cfg.nbins
    # the accumulator entries this call's lanes reach: the nonzero exact sums
    touched = sum(int((ref != 0).sum()) for ref in exact.values())
    stokes = {}
    if quv is not None:
        k = accs["kernel"]
        stokes = dict(stokes_v_zero=float(k["stokes"][2].abs().max()) == 0.0
                      and float(k.get("frame_stokes", k["stokes"])[2].abs()
                                .max()) == 0.0,
                      stokes_max_abs_err=max(err["kernel_stokes"],
                                             err.get("kernel_frame_stokes",
                                                     0.0)))
    # max_abs_err: of the SED and the frame against their exact sums; the
    # statistics rows, sums of powers up to c^4, in err_of_max
    return dict(**stokes,
        max_abs_err=max(err["kernel_sed"], err.get("kernel_frame", 0.0)),
        max_err_of_max=max(v for k, v in rel.items()
                           if k.startswith("kernel")),
        err_of_max=rel, bins=nb, touched_entries=touched,
        frame_bins=nb * cfg.npy * cfg.npx if cfg.has_frame else 0,
        lit_lanes=int((active & (contrib > 0)).sum()),
        ms=ms["kernel"], plain_ms=ms["plain"], seven_call_ms=ms["seven"],
        library_ms=None, device_ms=dev_t["kernel"]["all"],
        device_launches=dev_t["kernel"]["launches"],
        plain_device_ms=dev_t["plain"]["all"],
        plain_device_launches=dev_t["plain"]["launches"],
        seven_call_device_ms=dev_t["seven"]["all"],
        seven_call_device_launches=dev_t["seven"]["launches"],
        **bound(B * (4 + 12 + 4 + 1 + (12 if quv is not None else 0))
                + (nb + 1) * 4 + 2 * 4 * touched, B * OPS_DETECT))


INV_SQRT = 0.7   # the tests' 1/sqrt(rf_scale): any value that rounds


def check_deposit(torch, name, kern, plain, args, h) -> dict:
    """Kernel 2 in one mode against its plain version on the same CUDA
    tensors: found agreement >= 0.999, icell identical where both found,
    s_int within 1e-5 h, RF within 1e-4 of its maximum; then its time per
    call, device time and the plain version's time."""
    rf_k, s_k, c_k, f_k = kern(*args)
    rf_p, s_p, c_p, f_p = plain(*args)
    torch.cuda.synchronize()
    B = s_k.shape[0]
    agree = float((f_k == f_p).float().mean())
    both = f_k & f_p
    require(int(f_p.sum()) > B // 2, f"{name} test rays interact")
    require(agree >= 0.999, f"{name} found agreement {agree} >= 0.999")
    require(bool(torch.equal(c_k[both], c_p[both])),
            f"{name} icell identical where both found")
    ds_err = float((s_k[both] - s_p[both]).abs().max())
    require(ds_err <= 1e-5 * h, f"{name} s_int error {ds_err} <= 1e-5 h")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-4 * rf_max,
            f"{name} rf error {rf_err} <= 1e-4 * {rf_max}")
    rows_lit = int((rf_p.abs().sum(dim=1) > 0).sum())
    return dict(max_abs_err=rf_err, rf_max=rf_max, found_agreement=agree,
                s_int_err=ds_err, rows=rf_k.shape[0], rf_rows_lit=rows_lit,
                outputs=(rf_k, s_k, c_k, f_k),
                ms=cuda_ms(lambda: kern(*args)),
                plain_ms=cuda_ms(lambda: plain(*args), reps=3),
                library_ms=None,
                device_ms=device_ms(lambda: kern(*args))["ours"])


def deposit_bound(name, tabs, B, n_act, rows) -> dict:
    """Kernel 2's bound from this run's inputs: the lane inputs, the
    density table, the per-(slab, lane) inputs at the crossed pairs only
    (scale and rel, or the prefix tb), lum and tau_int in the prefix mode,
    the RF rows and the per-lane outputs; the operations of the crossed
    pairs."""
    per_pair = 8 if name == "sweep_deposit" else 4
    per_lane = 0 if name == "sweep_deposit" else 8
    return bound(lane_bytes(B, tabs.ncomp) + tabs.nd.numel() * 4
                 + n_act * per_pair + B * per_lane
                 + rows * tabs.nd.shape[0] * 4 + B * 12,
                 n_act * (OPS_SLAB + 3 * (OPS_SUB + 2 * tabs.ncomp + OPS_DEP)))


def active_slabs(tabs, pos, dirn, g, smin, smax) -> int:
    """(slab, lane) pairs whose slab the ray crosses (uniform grids)."""
    from skirt9_tpu_torch.transport import sweep as sw
    return int(sw._slab_cells(tabs, pos, dirn, g, smin, smax)[1].sum())


# ------------------------------------------------------------------ phases

def phase_env(torch) -> str:
    from skirt9_tpu_torch.kernels import build as kb
    nvcc = subprocess.run([kb._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    smi = nvidia_smi_line()
    emit({"phase": "env", "python": platform.python_version(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc[-1], "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})
    return smi


def phase_build() -> None:
    from skirt9_tpu_torch.kernels import build as kb
    t0 = time.perf_counter()
    kb.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cached": kb.build_info.get("cached"),
          "flags": " ".join(kb.NVCC_FLAGS),
          "ptxas": [ln for ln in kb.build_info.get("ptxas", "").splitlines()
                    if "registers" in ln or "Compiling entry" in ln]})


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version on the same CUDA tensors."""
    from skirt9_tpu_torch.ops import scatteradd as sca
    from skirt9_tpu_torch.transport import sweep as sw
    dev = torch.device("cuda")
    sim = config1(dev)
    tabs = sim._sweep_tabs
    h = float(tabs.h[0])
    B = B_FULL
    rs = np.random.default_rng(1)
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    pos, dirn, sig, active = sphere_rays(torch, sim, rs, B)
    out = {}

    # kernel 1 in its three output modes, the lane set-up inside: the event
    # march (own dominant axes) and the peel-off march (+z, axis hint 2)
    kz = torch.zeros_like(dirn)
    kz[:, 2] = 1.0
    err1 = rel_tot = rel_pre = abs_tot = abs_pre = 0.0
    for d_, hint in ((dirn, None), (kz, 2)):
        args = (tabs, pos, d_, sig, active, hint)
        a_k, a_p = sw.sweep_dtau(*args), sw.sweep_dtau_plain(*args)
        t_k, t_p = sw.sweep_tau_total(*args), sw.sweep_tau_total_plain(*args)
        tb_k, tot_k, lane_k = sw.sweep_dtau_prefix(*args)
        tb_p, _, lane_p = sw.sweep_dtau_prefix_plain(*args)
        torch.cuda.synchronize()
        require(bool((t_p > 0).sum() > B // 2), "kernel 1 test rays see dust")
        err1 = max(err1, float((a_k - a_p).abs().max()))
        require(bool(torch.equal(a_k, a_p)),
                f"kernel 1 (sweep_dtau) bit-identical to its plain version "
                f"(hint {hint}: max error {err1})")
        scale = t_p.clamp_min(1e-30)
        rel_tot = max(rel_tot, float(((t_k - t_p).abs() / scale).max()),
                      float(((tot_k - t_p).abs() / scale).max()))
        rel_pre = max(rel_pre,
                      float(((tb_k - tb_p).abs() / scale[None, :]).max()))
        abs_tot = max(abs_tot, float((t_k - t_p).abs().max()))
        abs_pre = max(abs_pre, float((tb_k - tb_p).abs().max()))
        for a, b, name in zip(lane_k, lane_p, ("axis", "smin", "smax")):
            require(bool(torch.equal(a, b)),
                    f"kernel 1 lane {name} bit-identical to _lane_range")
    require(rel_tot <= 1e-6,
            f"kernel 1 totals within 1e-6 of each lane's tau ({rel_tot})")
    require(rel_pre <= 1e-6,
            f"kernel 1 prefix within 1e-6 of each lane's tau ({rel_pre})")
    g, smin, smax, sg = sw._prep(tabs, pos, dirn, sig, active)
    a_p = sw._dtau_plain(tabs, pos, dirn, g, smin, smax, sg)
    n_act = active_slabs(tabs, pos, dirn, g, smin, smax)
    tab_bytes = tabs.nd.numel() * 4
    ev = (tabs, pos, dirn, sig, active)
    march_ops = B * OPS_LANE + n_act * (OPS_SLAB + 3 * (OPS_SUB + 2) + 2)
    dmaj = dirn.gather(1, g.long()[:, None])[:, 0] > 0
    modes = {
        # mode: kernel, plain version, the unfused form on this kernel,
        # output bytes, extra operations, errors (absolute, of the lane's tau)
        "sweep_dtau": (sw.sweep_dtau, sw.sweep_dtau_plain, None,
                       tabs.nmax * B * 4, 0, err1, 0.0),
        "sweep_tau_total": (sw.sweep_tau_total, sw.sweep_tau_total_plain,
                            lambda: sw.sweep_dtau(*ev).sum(0), B * 4, n_act,
                            abs_tot, rel_tot),
        "sweep_dtau_prefix": (
            sw.sweep_dtau_prefix, sw.sweep_dtau_prefix_plain,
            lambda: sw.slab_prefix(sw.sweep_dtau(*ev), dmaj),
            tabs.nmax * B * 4 + 4 * B * 4, 2 * n_act, abs_pre, rel_pre)}
    for name, (fn, plain, unfused, out_bytes, ops, e_abs, e_rel) \
            in modes.items():
        out[name] = dict(
            max_abs_err=e_abs, max_err_of_tau=e_rel,
            ms=cuda_ms(lambda: fn(*ev)), plain_ms=cuda_ms(lambda: plain(*ev),
                                                         reps=5),
            library_ms=None, active_pairs=n_act,
            device_ms=device_ms(lambda: fn(*ev))["ours"],
            **bound(ray_bytes(B, 1) + tab_bytes + out_bytes, march_ops + ops))
        if unfused is not None:
            out[name]["unfused_ms"] = cuda_ms(unfused)
            out[name]["unfused_device_ms"] = device_ms(unfused)["all"]

    # kernel 2 in both modes: deposits with nonzero scale, interaction at a
    # random depth; the reference contract on the tables the prefix mode
    # forms inside
    tb, tot = sw.slab_prefix(a_p, dmaj)
    lum = t32(rs.uniform(0.5, 2.0, B))
    tau_int = t32(rs.uniform(size=B)) * tot
    scale = (lum[None, :] * torch.exp(-tb)) * INV_SQRT
    rel = tau_int[None, :] - tb
    dep = {"sweep_deposit": (sw._deposit_cuda, sw._deposit_plain, (
               tabs, pos, dirn, g, smin, smax, sg, scale, rel, 1)),
           "sweep_deposit_prefix": (
               sw._deposit_prefix_cuda, sw._deposit_prefix_plain, (
                   tabs, pos, dirn, g, smin, smax, sg, lum, tau_int, tb,
                   INV_SQRT, 1, None, 1))}
    n_act = active_slabs(tabs, pos, dirn, g, smin, smax)
    for name, (kern, plain, args) in dep.items():
        res = check_deposit(torch, name, kern, plain, args, h)
        # scale and rel formed inside equal the torch tensors: the same
        # interaction points as the reference contract fed those tensors
        if name == "sweep_deposit_prefix":
            require(all(bool(torch.equal(a, b)) for a, b in zip(
                res.pop("outputs")[1:], out["sweep_deposit"]["outputs"][1:])),
                "kernel 2's modes find the same interactions bit for bit")
        out[name] = res
        out[name].update(deposit_bound(name, tabs, B, n_act, res["rows"]))
    for name in dep:
        out[name].pop("outputs", None)
    # the full_width path stores no RF: every lane's scale is zero there
    no_rf = list(dep["sweep_deposit_prefix"][2])
    no_rf[7] = torch.zeros_like(lum)
    out["sweep_deposit_prefix"]["device_ms_no_rf"] = device_ms(
        lambda: sw._deposit_prefix_cuda(*no_rf))["ours"]

    # kernel 3: the SED / statistics bin (size 1) and the frame (size 4096)
    err3, times = 0.0, {}
    for size in (1, 4096):
        idx = torch.tensor(rs.integers(0, size, B).astype(np.int32),
                           device=dev)
        val = t32(rs.uniform(size=B) * (rs.uniform(size=B) > 0.2))
        k_ = sca.scatter_add(idx, val, size)
        p_ = sca.scatter_add_plain(idx, val, size)
        torch.cuda.synchronize()
        e = float((k_ - p_).abs().max())
        require(e <= 1e-5 * float(p_.abs().max()),
                f"kernel 3 size {size} error {e} <= 1e-5 relative")
        err3 = max(err3, e)
        # the library yardstick: one index_add_ call into a zeroed table
        acc, idx64 = torch.zeros(size, device=dev), idx.long()
        times[size] = (cuda_ms(lambda: sca.scatter_add(idx, val, size)),
                       cuda_ms(lambda: sca.scatter_add_plain(idx, val, size)),
                       cuda_ms(lambda: acc.index_add_(0, idx64, val)),
                       device_ms(lambda: sca.scatter_add(idx, val, size)),
                       device_ms(lambda: acc.index_add_(0, idx64, val)))
    out["scatter_add"] = dict(
        max_abs_err=err3, ms=times[4096][0], plain_ms=times[4096][1],
        library_ms=times[4096][2], ms_size1=times[1][0],
        plain_ms_size1=times[1][1], library_ms_size1=times[1][2],
        device_ms=times[4096][3]["ours"],
        library_device_ms=times[4096][4]["all"],
        device_ms_size1=times[1][3]["ours"],
        library_device_ms_size1=times[1][4]["all"],
        **bound(B * 8 + 4096 * 4, B))

    # the detect kernel at config 1's shapes (one SED bin, statistics, a
    # 64x64 frame): scattered peel-off from the test rays' positions
    lam = torch.full((B,), 0.55e-6, dtype=torch.float32, device=dev)
    contrib = t32(rs.uniform(0.0, 1e-3, B) * (rs.uniform(size=B) > 0.1))
    out["detect"] = check_detect(torch, sim.instruments[0], sim._inst_tabs[0],
                                 lam, pos, contrib, active, 2)
    emit({"phase": "kernels", "batch": B, "grid": list(tabs.n), **out})
    return out


def phase_kernels_xl(torch) -> dict:
    """Kernel 6 in its four modes and kernel 7 against their plain versions
    at bench_config1x256's shapes, on lanes sorted as the path sorts them
    (the peel-off toward +z in entry-slab order): the record and the summed
    form bit for bit, the total and the prefix within 1e-6 of each lane's
    tau, the lane range equal to `_lane_range` bit for bit; then timings,
    with kernel 6 on unsorted lanes, kernel 1 on the same rays, and the
    kernel-6 variants of perf/kernel6_variants.py (other run lengths, the
    lane-block and lane-tile designs, and the first design's split)."""
    from perf import kernel6_variants as k6v
    from perf import kernel7_variants as k7v
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    sim = config1("cuda", num_packets=B_FULL, n=256)
    tabs = sim._sweep_tabs
    require(isinstance(tabs, xl.XLTables), "256^3 builds the XL tables")
    B = B_FULL
    rs = np.random.default_rng(2)
    pos_u, dir_u, sig, act_u = sphere_rays(torch, sim, rs, B)
    perm = xl.lane_order(tabs, pos_u, dir_u, sw.dominant_axis(tabs, dir_u))
    pos, dirn, active = pos_u[perm], dir_u[perm], act_u[perm]
    # peel-off toward +z: entry-slab order, one shared slab axis
    prm_z = xl.entry_order(tabs, pos_u, 2)
    kz = torch.zeros_like(dirn)
    kz[:, 2] = 1.0
    ev = (tabs, pos, dirn, sig, active, None)
    pl = (tabs, pos_u[prm_z], kz, sig, act_u[prm_z], 2)
    ev_u = (tabs, pos_u, dir_u, sig, act_u, None)
    out = {}

    # kernel 6: the record and summed forms bit for bit, the total and the
    # prefix within 1e-6 of each lane's tau, the lane range bit for bit
    rec_p, tb_p, tot_p, lane_p = xl.sweep_dtau_prefix_plain(*ev)
    sub_k = xl.sweep_dtau(*ev, want_sub=True)
    torch.cuda.synchronize()
    require(bool((tot_p > 0).sum() > B // 2), "kernel 6 test rays see dust")
    err6 = float((sub_k - rec_p).abs().max())
    require(bool(torch.equal(sub_k, rec_p)),
            f"kernel 6 record bit-identical ({err6})")
    del sub_k
    err_sum = 0.0
    for args in (ev, pl):
        sum_k, sum_p = xl.sweep_dtau(*args), xl.sweep_dtau_plain(*args)
        torch.cuda.synchronize()
        err_sum = max(err_sum, float((sum_k - sum_p).abs().max()))
        require(bool(torch.equal(sum_k, sum_p)),
                f"kernel 6 summed form bit-identical ({err_sum})")
    del sum_k, sum_p
    rel = lambda a, b, tau: float(((a - b).abs() / tau.clamp_min(1e-30)).max())
    tot_z_p = xl.sweep_tau_total_plain(*pl)
    tot_z = xl.sweep_tau_total(*pl)
    tot_e = xl.sweep_tau_total(*ev)
    rec_k, tb_k, tot_k, lane_k = xl.sweep_dtau_prefix(*ev)
    torch.cuda.synchronize()
    require(bool((tot_z_p > 0).sum() > B // 2), "peel-off rays see dust")
    rel_tot = max(rel(tot_z, tot_z_p, tot_z_p), rel(tot_e, tot_p, tot_p),
                  rel(tot_k, tot_p, tot_p))
    rel_pre = rel(tb_k, tb_p, tot_p[None, :])
    up = dirn.gather(1, lane_p[0].long()[:, None])[:, 0] > 0
    lane_err = ((tb_k - tb_p).abs() / tot_p.clamp_min(1e-30)).amax(0)
    require(rel_tot <= 1e-6,
            f"kernel 6 totals within 1e-6 of each lane's tau ({rel_tot})")
    require(rel_pre <= 1e-6,
            f"kernel 6 prefix within 1e-6 of each lane's tau ({rel_pre}; "
            f"along the slabs {float(lane_err[up].max())}, against them "
            f"{float(lane_err[~up].max())})")
    require(bool(torch.equal(rec_k, rec_p)), "kernel 6 prefix mode's record")
    for a, b, name in zip(lane_k, lane_p, ("axis", "smin", "smax")):
        require(bool(torch.equal(a, b)),
                f"kernel 6 lane {name} bit-identical to _lane_range")
    abs_tot = max(float((tot_z - tot_z_p).abs().max()),
                  float((tot_k - tot_p).abs().max()))
    abs_pre = float((tb_k - tb_p).abs().max())
    g, smin, smax = lane_p
    del rec_k, tb_k, rec_p

    # kernel 7: deposits from the record with a nonzero scale
    sub = xl.sweep_dtau(*ev, want_sub=True)
    lum = torch.tensor(rs.uniform(0.5, 2.0, B), dtype=torch.float32,
                       device=dirn.device)
    scale = lum[None, :] * torch.exp(-tb_p)
    dep = (tabs, pos, dirn, g, smin, smax, sub, scale, 1)
    rf_k = xl._deposit_cuda(*dep)
    rf_p = xl._deposit_plain(*dep)
    torch.cuda.synchronize()
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-4 * rf_max,
            f"kernel 7 rf error {rf_err} <= 1e-4 * {rf_max}")
    del rf_k, rf_p

    # kernel 7's prefix mode on pass 1's record, prefix and lane range, as
    # the event loop calls it: with an RF, with lum_half = 0 and without an
    # RF; tau_int sampled up to 1.1 tau, a sixteenth of it 0
    u = rs.uniform(0.0, 1.1, B)
    u[:B // 16] = 0.0
    tau_int = torch.tensor(u, dtype=torch.float32, device=dirn.device) * tot_p
    act_int = active & (tot_p > 1e-6)
    lum_h = lum * active
    pre = lambda lm: (tabs, pos, dirn, act_int, sub, lm, tau_int, tb_p,
                      INV_SQRT, lane_p)
    pre_err = 0.0
    for what, lm in (("an RF", lum_h), ("lum_half = 0", torch.zeros_like(lum)),
                     ("no RF", None)):
        rf_k, *hit_k = xl.sweep_deposit_prefix(*pre(lm))
        rf_p, *hit_p = xl.sweep_deposit_prefix_plain(*pre(lm))
        torch.cuda.synchronize()
        require(int(hit_p[2].sum()) > B // 2, "kernel 7 test rays interact")
        for a, b, name in zip(hit_k, hit_p, ("s_int", "icell", "found")):
            require(bool(torch.equal(a, b)),
                    f"kernel 7 prefix mode's {name} identical ({what})")
        if lm is None:
            require(rf_k is None and rf_p is None, "no RF without lum_half")
            continue
        e = float((rf_k - rf_p).abs().max())
        m = float(rf_p.abs().max())
        require(e <= 1e-4 * m if lm is lum_h else (m == 0 and e == 0),
                f"kernel 7 prefix mode's rf error {e} <= 1e-4 * {m} ({what})")
        if lm is lum_h:
            pre_err, pre_max = e, m
    del rf_k, rf_p, hit_k, hit_p
    torch.cuda.empty_cache()

    # timings of kernel 6's modes: the event rays (record, summed, prefix),
    # the +z peel-off rays (summed, total)
    n_act = active_slabs(tabs, pos, dirn, g, smin, smax)
    gz, sminz, smaxz, _ = sw._prep(tabs, pl[1], kz, sig, pl[4])
    n_act_z = active_slabs(tabs, pl[1], kz, torch.full_like(gz, 2), sminz,
                           smaxz)
    rec = tabs.nmax * B * 4
    base = ray_bytes(B, 1) + tabs.nd.numel() * 4
    march = lambda n: B * OPS_LANE + n * (OPS_SLAB + 3 * (OPS_SUB + 2) + 2)
    dmaj = dirn.gather(1, g.long()[:, None])[:, 0] > 0
    modes = {
        # name: (kernel, plain version, the unfused form it replaces on the
        # path, rays, output bytes, operations, errors: absolute, of tau)
        "sweepxl_dtau": (
            lambda *a: xl.sweep_dtau(*a, want_sub=True),
            lambda *a: xl.sweep_dtau_plain(*a, want_sub=True), None, ev,
            3 * rec, march(n_act), err6, 0.0),
        "sweepxl_dtau_summed": (
            xl.sweep_dtau, xl.sweep_dtau_plain, None, pl, rec,
            march(n_act_z), err_sum, 0.0),
        "sweepxl_tau_total": (
            xl.sweep_tau_total, xl.sweep_tau_total_plain,
            lambda *a: xl.sweep_dtau(*a).sum(0), pl, B * 4,
            march(n_act_z) + n_act_z, abs_tot, rel_tot),
        "sweepxl_dtau_prefix": (
            xl.sweep_dtau_prefix, xl.sweep_dtau_prefix_plain,
            lambda *a: sw.slab_prefix(
                xl.sweep_dtau(*a, want_sub=True).sum(dim=1), dmaj),
            ev, 4 * rec + 4 * B * 4, march(n_act) + 2 * n_act, abs_pre,
            rel_pre)}
    for name, (fn, plain, unfused, args, out_bytes, ops, e_abs, e_rel) \
            in modes.items():
        out[name] = dict(
            max_abs_err=e_abs, max_err_of_tau=e_rel,
            ms=cuda_ms(lambda: fn(*args)),
            device_ms=device_ms(lambda: fn(*args))["ours"],
            plain_ms=cuda_ms(lambda: plain(*args), reps=3), library_ms=None,
            active_pairs=n_act_z if args is pl else n_act,
            **bound(base + out_bytes, ops))
        if unfused is not None:
            out[name]["unfused_ms"] = cuda_ms(lambda: unfused(*args))
            out[name]["unfused_device_ms"] = device_ms(
                lambda: unfused(*args))["all"]
        torch.cuda.empty_cache()
    k6 = out["sweepxl_dtau"]
    k6["ms_unsorted"] = cuda_ms(lambda: xl.sweep_dtau(*ev_u, want_sub=True))
    k6["prefix_ms_unsorted"] = cuda_ms(lambda: xl.sweep_dtau_prefix(*ev_u))
    k6["kernel1_ms_sorted"] = cuda_ms(lambda: sw.sweep_dtau(*ev))
    k6["kernel1_ms_unsorted"] = cuda_ms(lambda: sw.sweep_dtau(*ev_u))
    k6["variants"] = k6v.measure(torch, tabs, ev[1:5], ev_u[1:5], cuda_ms,
                                 device_ms)
    torch.cuda.empty_cache()
    ms7 = cuda_ms(lambda: xl._deposit_cuda(*dep))
    dms7 = device_ms(lambda: xl._deposit_cuda(*dep))["ours"]
    pms7 = cuda_ms(lambda: xl._deposit_plain(*dep), reps=3)
    ncells = tabs.nd.shape[0]
    out["sweepxl_deposit"] = dict(
        max_abs_err=rf_err, rf_max=rf_max, ms=ms7, device_ms=dms7,
        plain_ms=pms7, library_ms=None,
        **bound(lane_bytes(B, 0) + 4 * rec + ncells * 4,
                n_act * (OPS_SLAB + 3 * (OPS_SUB + OPS_DEP))))
    # the prefix mode against the parent's unfused form on the same inputs:
    # scale_slab, kernel 7's table mode and resolve_interaction
    kern = lambda lm: xl.sweep_deposit_prefix(*pre(lm))
    resolve = lambda: xl.resolve_interaction(tabs, pos, dirn, act_int, sub,
                                             tb_p, tau_int, lane=lane_p)
    unfused = lambda: (xl.sweep_deposit(
        tabs, pos, dirn, active, sub,
        (lum_h[None, :] * torch.exp(-tb_p)) * INV_SQRT, lane=lane_p),
        resolve())
    # bytes: the lane inputs, lum, tau_int and the mask, the prefix, the
    # record at the crossed pairs and at the hit slab, the RF and the
    # per-lane outputs; operations: the crossed pairs' deposits, pass B's
    # slab, the hit test per (slab, lane)
    in_b = lane_bytes(B, 0) + 9 * B + tabs.nmax * B * 4 + 12 * B + 13 * B
    ops_b = B * (OPS_SLAB + 3 * OPS_SUB + 12) + 3 * tabs.nmax * B
    d_rf, d_res = device_ms(lambda: kern(lum_h)), device_ms(resolve)
    out["sweepxl_deposit_prefix"] = dict(
        max_abs_err=pre_err, rf_max=pre_max,
        ms=cuda_ms(lambda: kern(lum_h)), device_ms=d_rf["ours"],
        device_ms_all=d_rf["all"], ms_no_rf=cuda_ms(lambda: kern(None)),
        device_ms_no_rf=device_ms(lambda: kern(None))["ours"],
        plain_ms=cuda_ms(lambda: xl.sweep_deposit_prefix_plain(
            *pre(lum_h)), reps=3),
        library_ms=None, unfused_ms=cuda_ms(unfused),
        unfused_device_ms=device_ms(unfused)["all"],
        unfused_no_rf_ms=cuda_ms(resolve),
        resolve_interaction_device_ms=d_res["all"],
        resolve_interaction_launches=d_res["launches"],
        bound_no_rf_ms=bound(in_b, ops_b)["bound_ms"],
        **bound(in_b + n_act * 12 + ncells * 4,
                ops_b + n_act * (OPS_SLAB + 3 * (OPS_SUB + OPS_DEP))))
    out["sweepxl_deposit"]["variants"] = k7v.measure(
        torch, tabs, (pos, dirn, lane_p, act_int, sub, lum_h, tau_int, tb_p,
                      INV_SQRT, scale), cuda_ms, device_ms)
    emit({"phase": "kernels_xl", "batch": B, "grid": list(tabs.n), **out})
    return out


def _sed(sim, accs):
    from skirt9_tpu_torch.instruments import distant as dinst
    return dinst.calibrate_sed(sim.instruments[0], accs[0])


def phase_draw_for_draw(torch, phase="draw_for_draw", n=32,
                        tables="SweepTables") -> None:
    res = {}
    for store_rf in (False, True):
        runs = {}
        for device in ("cpu", "cuda"):
            sim = config1(device, num_packets=16384, batch_size=4096, n=n,
                          store_rf=store_rf)
            require(type(sim._sweep_tabs).__name__ == tables,
                    f"{n}^3 builds {tables}")
            rf, accs = sim.run_primary(verbose=False)
            runs[device] = (sim, rf, accs)
        (sc, rfc, ac), (sg, rfg, ag) = runs["cpu"], runs["cuda"]
        sed_c, sed_g = _sed(sc, ac), _sed(sg, ag)
        worst = 0.0
        for kind in ("transparent", "primarydirect", "primaryscattered",
                     "total"):
            require(sed_c[kind][0] > 0, f"{kind} SED positive")
            e = abs(sed_g[kind][0] - sed_c[kind][0]) / sed_c[kind][0]
            require(e <= 1e-4, f"draw-for-draw {kind} SED {e} <= 1e-4")
            worst = max(worst, e)
        fc = ac[0]["frame"].double()
        fg = ag[0]["frame"].double().cpu()
        fe = float((fg - fc).abs().max() / fc.abs().max())
        require(fe <= 1e-3, f"draw-for-draw frame {fe} <= 1e-3 of max")
        entry = {"sed_rel_err": worst, "frame_err": fe}
        if store_rf:
            tc, tg = float(rfc.double().sum()), float(rfg.double().sum())
            e = abs(tg - tc) / tc
            require(tc > 0 and e <= 1e-4, f"draw-for-draw RF total {e}")
            entry["rf_total_rel_err"] = e
            entry["rf_cell_err"] = float((rfg.double().cpu() - rfc.double())
                                         .abs().max() / rfc.abs().max())
        res["rf" if store_rf else "no_rf"] = entry
    emit({"phase": phase, "grid": [n] * 3, "packets": 16384, "batch": 4096,
          **res})


# the resident sweep's path: kernel 1 as the tracer's total and pass 1's
# prefix, kernel 2 from that prefix (the reference contracts, modes
# sweep_dtau and sweep_deposit, on no path); the XL path likewise with
# kernel 6 and kernel 7 from its prefix, with or without an RF (their
# reference modes, counted as sweepxl_dtau and sweepxl_deposit, on no path)
RESIDENT = ("sweep_tau_total", "sweep_dtau_prefix", "sweep_deposit_prefix")
XL = ("sweepxl_tau_total", "sweepxl_dtau_prefix", "sweepxl_deposit_prefix")
# the tree path: kernel 4 as the tracer's total and pass 1's prefix (its
# reference modes, counted as mlsweep_dtau, on no path), kernel 5 with an RF
ML_PASS1 = ("mlsweep_tau_total", "mlsweep_dtau_prefix")
ML = ML_PASS1 + ("mlsweep_deposit",)
# every path detects through the fused kernel, never through kernel 3, and
# takes kernels 1, 2, 4, 6 and 7 in their fused modes, never in the
# reference's
DETECT = ("detect",)
# the launch directions' sinf and cosf and the HG scattering direction
# (csrc/sincos.cu), on every path that launches and scatters
DIRECTIONS = ("sincos", "hg_direction")
NOT_PATH = ("sweep_dtau", "sweep_deposit", "sweepxl_dtau", "sweepxl_deposit",
            "mlsweep_dtau", "scatter_add")


def phase_full_width(torch, smi: str, phase="full_width", tables="SweepTables",
                     must=RESIDENT + DETECT + DIRECTIONS,
                     must_not=XL + ML + NOT_PATH, **kw):
    """A config-1 path at full width, timed after one warm-up run, with the
    correctness gates. kw: config1's arguments (grid size, packets)."""
    sim = config1("cuda", **kw)
    require(type(sim._sweep_tabs).__name__ == tables,
            f"{sim.grid.nx}^3 builds {tables}")
    one_batch(sim, sim.run_primary)            # warm-up
    (rf, accs), launches = drive(must, must_not,
                                 lambda: sim.run_primary(verbose=False))
    stats = dict(sim.last_stats)
    gates = config1_gates(sim, accs)
    emit({"phase": phase, "grid": list(sim.grid.shape),
          "tables": tables, "packets": sim.num_packets,
          "batch": sim.batch_size, "packets_per_s": sim.last_rate,
          "seconds": stats["seconds"], "events": stats["events"],
          "launches": launches, **gates,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    stats["gates"] = gates
    return sim, stats, launches


def config1_gates(sim, accs, direct: bool = True) -> dict:
    """Config 1's gates on a run: the transparent SED analytic within 1e-5,
    direct/transparent = exp(-tau) of the +z ray within 1e-3 (on a uniform
    grid; skipped with direct=False), SED relative error R < 0.01, the SED
    and frame files finite and lit. Returns the measured values."""
    from skirt9_tpu_torch.utils.fits import read_fits
    sed = _sed(sim, accs)
    cfg = sim.instruments[0]
    dlam = cfg.wave_borders[1] - cfg.wave_borders[0]
    expect = 1.0 / (4.0 * math.pi * cfg.distance ** 2 * dlam)
    e_tr = abs(sed["transparent"][0] - expect) / expect
    require(e_tr <= 1e-5, f"transparent SED {e_tr} <= 1e-5 of L/(4 pi d^2)")
    ratio = sed["primarydirect"][0] / sed["transparent"][0]
    out = {"transparent_rel_err": e_tr, "direct_over_transparent": ratio}
    if direct:
        # optical depth of the +z ray from the source, summed in numpy over
        # the cells it crosses (the source sits on the corner of the
        # central cells)
        n = sim.grid.nx
        nd = sim.medium.nd[:, 0].double().cpu().numpy().reshape(n, n, n)
        h = float(sim.grid.h[2])
        tau_grid = float(nd[n // 2, n // 2, n // 2:].sum() * 1e-24 * h)
        e_dir = abs(ratio - math.exp(-tau_grid))
        require(e_dir <= 1e-3, f"direct/transparent {ratio} vs "
                f"exp(-{tau_grid}) within 1e-3")
        out["exp_minus_tau"] = math.exp(-tau_grid)
    require(sed["R"][0] < 0.01, f"SED relative error R {sed['R'][0]} < 0.01")
    with tempfile.TemporaryDirectory() as tmp:
        paths = sim.write_outputs(accs, "config1", tmp)
        cube, _ = read_fits(paths[1])
        sed_cols = np.loadtxt(paths[0])
    require(cube.shape == (1, 64, 64) and bool(np.isfinite(cube).all())
            and cube.max() > 0, "frame FITS finite and lit")
    require(bool(np.all(np.isfinite(sed_cols))), "SED file finite")
    return dict(out, R=float(sed["R"][0]), scattered=float(
        sed["primaryscattered"][0]), scattered_over_transparent=float(
        sed["primaryscattered"][0] / sed["transparent"][0]))


def host_per_event(torch, sim, run, warm: bool = False) -> dict:
    """One batch of a configuration profiled (event_profile.profile_run),
    after a warm-up unless the simulation has run already (warm): device
    operations, kernel launches, stream syncs and copies per event of the
    loop and of the whole run, and the device's busy and idle shares. The
    events are capped at 8 (every event of a loop issues the same
    operations; the profiler's cost grows with them)."""
    import dataclasses
    from skirt9_tpu_torch.tools import event_profile as ep
    opts = sim.options
    sim.options = dataclasses.replace(opts, max_events=min(opts.max_events,
                                                           8))
    try:
        if not warm:
            run(sim)                             # warm-up
        prof = ep.profile_run(torch, lambda: run(sim))
    finally:
        sim.options = opts
    events = ep._events(sim)
    require(prof["loop_ranges"] > 0 and prof["loop"]["h2d_copies"] == 0,
            f"no host-to-device copy in the event loop: {prof['loop']}")
    return {"profiled_wall_s": prof["wall_s"], "device_busy_s": prof["busy_s"],
            "idle_share": prof["idle_share"], "events": events,
            "device_launches": prof["whole"]["device_ops"],
            "per_event": ep.per_event(prof, events),
            "unattributed": prof["unattributed"], "top": prof["top"]}


def phase_breakdown(torch, sim, stats) -> None:
    """Shares of the timed run spent blocked in the early-exit host sync and
    in threefry RNG (measured alone at the same width, times the draws the
    run made); then one batch under torch.profiler (host_per_event)."""
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.transport import lifecycle as lc
    dev = torch.device("cuda")
    B = sim.batch_size
    hist = torch.arange(B, dtype=torch.int64, device=dev)
    skey = rng.seed_key(0, dev)
    hkey = rng.history_keys(skey, hist)
    nscat = torch.zeros(B, dtype=torch.int64, device=dev)
    tags = lc._path_tags(sim.options) + (lc._TAG_SCATTER_CT,
                                         lc._TAG_SCATTER_PHI)
    ev_ms = cuda_ms(lambda: rng.uniforms(rng.event_keys(hkey, nscat), tags))
    launch_ms = cuda_ms(lambda: rng.isotropic_direction(
        rng.event_keys(rng.history_keys(skey, hist), rng.LAUNCH_EVENT),
        rng.LAUNCH_DIRECTION))
    batches = -(-sim.num_packets // B)
    rng_s = (stats["events"] * ev_ms + batches * launch_ms) / 1e3
    prof = host_per_event(
        torch, config1("cuda", num_packets=B),
        lambda s: s.run_primary(verbose=False))
    emit({"phase": "breakdown", "seconds": stats["seconds"],
          "events": stats["events"], "sync_wait_s": stats["sync_s"],
          "sync_share": stats["sync_s"] / stats["seconds"],
          "rng_ms_per_event": ev_ms, "rng_ms_per_launch": launch_ms,
          "rng_s": rng_s, "rng_share": rng_s / stats["seconds"],
          "profiled_batch": B, **prof})


def phase_rf_xl(torch) -> dict:
    """bench_config1x256 with a one-bin RF on the XL path (kernel 7), against
    the same seed on the resident sweep (kernels 1-2) put in place."""
    from skirt9_tpu_torch.transport import sweep as sw
    kw = dict(num_packets=B_FULL, n=256, store_rf=True)
    sim = config1("cuda", **kw)
    require(type(sim._sweep_tabs).__name__ == "XLTables", "256^3 builds XL")
    (rf, accs), launches = drive(XL + DETECT, RESIDENT + ML + NOT_PATH,
                                 lambda: sim.run_primary(verbose=False))
    stats = dict(sim.last_stats)
    require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0
            and float(rf.sum()) > 0, "XL RF finite and positive")
    res = config1("cuda", **kw)
    res._sweep_tabs = sw.build_tables(res.grid, res.medium)
    rf_r, _ = res.run_primary(verbose=False)
    tx, tr = float(rf.double().sum()), float(rf_r.double().sum())
    e = abs(tx - tr) / tr
    require(e <= 1e-4, f"XL vs resident RF total {e} <= 1e-4")
    cell = float((rf.double() - rf_r.double()).abs().max()
                 / rf_r.double().abs().max())
    emit({"phase": "rf_xl", "grid": list(sim.grid.shape),
          "packets": sim.num_packets, "seconds": stats["seconds"],
          "events": stats["events"], "packets_per_s": sim.last_rate,
          "launches": launches, "rf_total_rel_err": e,
          "rf_cell_err_of_max": cell})
    return launches


# ------------------------------------------------------------ tree grids

# bench_config3ism (bench.py:336-342) and bench_config3ismxl (:390-396):
# clumps, sites per clump, clump scale [pc], max_level
ISM = {"config3ism": (46, 26, 0.04, 7), "config3ismxl": (400, 96, 0.03, 8),
       # the same recipe at max_level 9: a 512^3 fine raster, which only the
       # XL contracts take (on the tree's voxel raster)
       "config3ismxl9": (400, 96, 0.03, 9)}


def config3ism(device, name="config3ism", store_rf=False,
               num_packets=1 << 17, batch_size=B_ML):
    """bench.py's clumpy-ISM configuration through the port's API: a
    site-list octree over (-1 pc, 1 pc)^3, uniform nd = 1/(sigma 2 pc) with
    sigma = 1e-25 m^2, albedo 0.5, g = 0.3, one distant instrument with a
    64x64 frame, 16 events. Returns (sim, host seconds of the tree build,
    host seconds of the Simulation set-up, which builds the tables)."""
    from skirt9_tpu_torch.grids.octree import build_octree, site_list_refine_fn
    from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.simulation import Simulation
    from skirt9_tpu_torch.sources.base import PointSource
    from skirt9_tpu_torch.transport.lifecycle import TransportOptions

    n_clumps, n_sites, scale, max_level = ISM[name]
    sigma = 1e-25
    rs = np.random.default_rng(9)
    cc = rs.uniform(-0.85, 0.85, size=(n_clumps, 3)) * PC
    sites = np.concatenate(
        [c + rs.normal(scale=scale * PC, size=(n_sites, 3)) for c in cc])
    t0 = time.perf_counter()
    grid = build_octree(((-PC, PC),) * 3, lambda p: np.ones(len(p)),
                        max_level=max_level, min_level=2,
                        refine_fn=site_list_refine_fn(sites, 1))
    t_tree = time.perf_counter() - t0
    nd = (1.0 / (sigma * 2 * PC)) * np.ones(grid.ncells, np.float32)
    med = msys.make_medium(grid, nd, np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), sigma),
                           albedo=np.full((1, 2), 0.5), g=np.full((1, 2), 0.3))
    inst = DistantInstrumentCfg(name="i0", wave_borders=(0.5e-6, 0.6e-6),
                                distance=100 * PC, npx=64, npy=64,
                                fovx=4 * PC, fovy=4 * PC)
    opts = TransportOptions(max_steps=grid.max_steps(), max_events=16,
                            store_rf=store_rf)
    t0 = time.perf_counter()
    sim = Simulation(grid=grid, medium=med,
                     sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                     instruments=[inst], options=opts,
                     rf_borders=(np.array([0.5e-6, 0.6e-6]) if store_rf
                                 else None),
                     num_packets=num_packets, batch_size=batch_size, seed=0,
                     device=device)
    return sim, t_tree, time.perf_counter() - t0


def box_rays(torch, sim, rs, B):
    """B packets uniform in the tree's box with isotropic directions: pos,
    dir (B, 3), cross sections (1, B), in-grid mask."""
    lo = sim.grid.box_lo.double().cpu().numpy()
    hi = sim.grid.box_hi.double().cpu().numpy()
    d = rs.normal(size=(B, 3))
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=sim.device)
    pos = t32(rs.uniform(lo, hi, (B, 3)))
    dirn = t32(d / np.linalg.norm(d, axis=1, keepdims=True))
    sig = torch.full((1, B), 1e-25, dtype=torch.float32, device=sim.device)
    return pos, dirn, sig, sim.grid.locate(pos) >= 0


def _dtau_ml(torch, sim, rs):
    """Kernel 4 against its plain version on one tree at B = 65536, both
    through the public wrappers (`mlsweep.sweep_dtau`, `sweep_dtau_plain`):
    the event record (want_sub: tau and leaf ids), the summed form, and the
    +z peel-off march with its axis hint; tau within 1e-5 relative and the
    leaf ids identical; then its total mode (the tracer's) and prefix mode
    (the loop's pass 1): the totals and the prefix within 1e-6 of each
    lane's tau, the record, leaf ids, step sums and lane range bit for bit.
    Then the timings of each mode (the lane set-up inside) beside the
    unfused forms that the parent's loop ran, the variants of
    perf/kernel4_variants.py, and the bounds. Returns (the record mode's
    entry, the total and prefix modes' entries, rays, lane set-up, the
    kernel's and the plain version's record)."""
    from perf import kernel4_variants as k4v
    from skirt9_tpu_torch.transport import mlsweep as ml
    from skirt9_tpu_torch.transport import sweep as sw
    tabs = sim._sweep_tabs
    require(isinstance(tabs, ml.MLTables), "the tree builds MLTables")
    B = B_ML
    rays = box_rays(torch, sim, rs, B)
    pos, dirn, sig, active = rays
    kz = torch.zeros_like(dirn)
    kz[:, 2] = 1.0
    sub_k, cell_k = ml.sweep_dtau(tabs, pos, dirn, sig, active, want_sub=True)
    sub_p, cell_p = ml.sweep_dtau_plain(tabs, pos, dirn, sig, active,
                                        want_sub=True)
    sum_k = ml.sweep_dtau(tabs, pos, dirn, sig, active)
    sum_p = ml.sweep_dtau_plain(tabs, pos, dirn, sig, active)
    z_k = ml.sweep_dtau(tabs, pos, kz, sig, active, axis_hint=2)
    z_p = ml.sweep_dtau_plain(tabs, pos, kz, sig, active, axis_hint=2)
    torch.cuda.synchronize()
    rel = 0.0
    for tk, tp in ((sub_k.sum(dim=(0, 1)), sub_p.sum(dim=(0, 1))),
                   (sum_k.sum(0), sum_p.sum(0)), (z_k.sum(0), z_p.sum(0))):
        require(bool((tp > 0).sum() > B // 2), "kernel 4 test rays see dust")
        rel = max(rel, float(((tk - tp).abs()
                              / tp.clamp_min(1e-30))[tp > 0].max()))
    require(rel <= 1e-5, f"kernel 4 max relative tau error {rel} <= 1e-5 "
            f"({tabs.n[0]}^3 raster)")
    require(bool(torch.equal(cell_k, cell_p)),
            f"kernel 4 leaf ids identical ({tabs.n[0]}^3 raster)")
    err = max(float((a - b).abs().max()) for a, b in
              ((sub_k, sub_p), (sum_k, sum_p), (z_k, z_p)))
    identical = all(bool(torch.equal(a, b)) for a, b in
                    ((sub_k, sub_p), (sum_k, sum_p), (z_k, z_p)))
    del sum_k, sum_p, z_k, z_p

    # modes 2 and 3: the total (the +z peel-off, as the tracer runs it, and
    # the event rays) and the prefix within 1e-6 of each lane's tau, the
    # record, leaf ids and step sums bit for bit, the lane range equal to
    # _lane_range
    ev = (tabs, pos, dirn, sig, active)
    pl = (tabs, pos, kz, sig, active, 2)
    rel_tau = lambda a, b, tau: float(((a - b).abs()
                                       / tau.clamp_min(1e-30)).max())
    tot_z_p = ml.sweep_tau_total_plain(*pl)
    tot_p = ml.sweep_tau_total_plain(*ev)
    tot_z, tot_e = ml.sweep_tau_total(*pl), ml.sweep_tau_total(*ev)
    pre_k = ml.sweep_dtau_prefix(*ev)
    pre_p = ml.sweep_dtau_prefix_plain(*ev)
    rec_n = ml.sweep_dtau_prefix(*ev, leaf_ids=False)
    torch.cuda.synchronize()
    require(bool((tot_z_p > 0).sum() > B // 2), "peel-off rays see dust")
    rel_tot = max(rel_tau(tot_z, tot_z_p, tot_z_p),
                  rel_tau(tot_e, tot_p, tot_p),
                  rel_tau(pre_k[4], tot_p, tot_p))
    rel_pre = rel_tau(pre_k[3], pre_p[3], tot_p[None, :])
    what = f"({tabs.n[0]}^3 raster)"
    require(rel_tot <= 1e-6,
            f"kernel 4 totals within 1e-6 of each lane's tau {what}: "
            f"{rel_tot}")
    require(rel_pre <= 1e-6,
            f"kernel 4 prefix within 1e-6 of each lane's tau {what}: "
            f"{rel_pre}")
    for a, b, name in ((pre_k[0], pre_p[0], "record"),
                       (pre_k[1], pre_p[1], "leaf ids"),
                       (pre_k[2], pre_p[2], "step sums"),
                       (rec_n[0], pre_p[0], "record without leaf ids"),
                       *zip(pre_k[5], pre_p[5], ("axis", "smin", "smax"))):
        require(bool(torch.equal(a, b)),
                f"kernel 4 prefix mode's {name} bit-identical {what}")
    require(rec_n[1] is None, "kernel 4 prefix mode without leaf ids")
    abs_tot = max(float((tot_z - tot_z_p).abs().max()),
                  float((pre_k[4] - tot_p).abs().max()))
    abs_pre = float((pre_k[3] - pre_p[3]).abs().max())
    del pre_k, pre_p, rec_n

    lanes = sw._prep(tabs, pos, dirn, sig, active)
    g, smin, smax, sg = lanes
    pms = cuda_ms(lambda: ml.sweep_dtau_plain(*ev, want_sub=True), reps=3)
    torch.cuda.empty_cache()
    rec_mode = lambda: ml.sweep_dtau(*ev, want_sub=True)
    ms = cuda_ms(rec_mode)
    dms = device_ms(rec_mode)["ours"]
    ms_sum = cuda_ms(lambda: ml.sweep_dtau(*ev))
    ms_peel = cuda_ms(lambda: ml.sweep_dtau(*pl))
    # the rate of PyTorch's own gather on the leaf map (L2-resident on a
    # 128^3 raster, not on a 256^3 one)
    flat = torch.randint(0, tabs.leafmap.numel(), (1 << 24,),
                         device=dirn.device)
    gather_ms = cuda_ms(lambda: tabs.leafmap[flat])
    gathers_per_s = flat.numel() / (gather_ms * 1e-3)
    del flat
    n_live = int(ml._plan_substeps(tabs, pos, dirn, g, smin, smax)[3].sum())
    gz, sminz, smaxz = sw._lane_range(tabs, pos, kz, active)
    n_live_z = int(ml._plan_substeps(tabs, pos, kz, torch.full_like(gz, 2),
                                     sminz, smaxz)[3].sum())
    NS = tabs.n_steps
    rec = NS * 3 * B * 4
    # inputs read once: the rays, the density, the leaf map, the plan
    base = (ray_bytes(B, 1) + tabs.nd.numel() * 4 + tabs.leafmap.numel() * 4
            + 2 * NS * 4)
    march = lambda n: B * OPS_LANE + n * (OPS_SLAB + 3 * (OPS_SUB + 2 + 1))
    entry = dict(
        max_abs_err=err, bit_identical=identical, max_rel_tau_err=rel, ms=ms,
        device_ms=dms, plain_ms=pms, library_ms=None, ms_summed=ms_sum,
        ms_peel_z=ms_peel, live_pairs=n_live, fine_grid=list(tabs.n),
        n_steps=NS, leaves=tabs.nd.shape[0], torch_gather_per_s=gathers_per_s,
        gather_bound_ms=2 * 3 * n_live / gathers_per_s * 1e3,
        **bound(base + 2 * rec, march(n_live)))
    # the parent's tree loop formed the lane range, the sums and the prefix
    # in torch around the record mode (the kernel forms the same lane range
    # again, bit for bit)
    dmaj = dirn.gather(1, g.long()[:, None])[:, 0] > 0

    def unfused_prefix():
        sw._lane_range(tabs, pos, dirn, active)
        r, c = ml.sweep_dtau(*ev, want_sub=True)
        return r, c, sw.slab_prefix(torch.sum(r, dim=1), dmaj)

    def unfused_total():
        sw._lane_range(tabs, pos, kz, active)
        return torch.sum(ml.sweep_dtau(*pl), dim=0)

    modes = {
        "mlsweep_tau_total": (
            lambda: ml.sweep_tau_total(*pl),
            lambda: ml.sweep_tau_total_plain(*pl), unfused_total,
            B * 4, march(n_live_z), abs_tot, rel_tot, n_live_z),
        "mlsweep_dtau_prefix": (
            lambda: ml.sweep_dtau_prefix(*ev),
            lambda: ml.sweep_dtau_prefix_plain(*ev), unfused_prefix,
            2 * rec + 2 * NS * B * 4 + 4 * B * 4, march(n_live) + 2 * NS * B,
            abs_pre, rel_pre, n_live)}
    more = {}
    for name, (fn, plain, unfused, out_b, ops, e_abs, e_rel, live) \
            in modes.items():
        more[name] = dict(
            max_abs_err=e_abs, max_err_of_tau=e_rel, ms=cuda_ms(fn),
            device_ms=device_ms(fn)["ours"],
            plain_ms=cuda_ms(plain, reps=3), library_ms=None,
            unfused_ms=cuda_ms(unfused),
            unfused_device_ms=device_ms(unfused)["all"], live_pairs=live,
            **bound(base + out_b, ops))
        torch.cuda.empty_cache()
    no_ids = lambda: ml.sweep_dtau_prefix(*ev, leaf_ids=False)
    more["mlsweep_dtau_prefix"].update(
        ms_no_leaf_ids=cuda_ms(no_ids),
        device_ms_no_leaf_ids=device_ms(no_ids)["ours"],
        bound_no_leaf_ids_ms=bound(base + rec + 2 * NS * B * 4 + 16 * B,
                                   march(n_live) + 2 * NS * B)["bound_ms"])
    entry["variants"] = k4v.measure(torch, tabs, rays, cuda_ms, device_ms)
    return entry, more, rays, lanes, (sub_k, cell_k), (sub_p, cell_p)


def _deposit_ml(torch, sim, rs, k4, rays, lanes, rec_k, rec_p) -> dict:
    """Kernel 5 against its plain version on one tree at B = 65536 through
    the public wrappers, on kernel 4's record and pass 1's lane range:
    RF within 1e-5 of its maximum, s_int within 1e-5 h, found and the
    interaction cells equal. Then its timings on the launch alone, pass 2
    as the path calls it (with the cell lookup) and, for the path without
    an RF, resolve_interaction in torch ops; and its bound, counting the
    record at the live (step, lane) pairs it reads."""
    from skirt9_tpu_torch.transport import mlsweep as ml
    from skirt9_tpu_torch.transport import sweep as sw
    tabs = sim._sweep_tabs
    B = B_ML
    pos, dirn, _, active = rays
    g, smin, smax, _ = lanes
    lane = (g, smin, smax)
    (sub_k, cell_k), (sub_p, cell_p) = rec_k, rec_p
    dmaj = dirn.gather(1, g.long()[:, None])[:, 0]
    tb, tot = sw.slab_prefix(sub_p.sum(dim=1), dmaj > 0)
    lum = torch.tensor(rs.uniform(0.5, 2.0, B), dtype=torch.float32,
                       device=dirn.device) * active
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=dirn.device) * tot
    rf_k, s_k, c_k, f_k = ml.sweep_deposit(tabs, pos, dirn, active, sub_p,
                                           cell_p, lum, tau_int, tb, 0.5,
                                           lane=lane)
    rf_p, s_p, c_p, f_p = ml.sweep_deposit_plain(tabs, pos, dirn, active,
                                                 sub_p, cell_p, lum, tau_int,
                                                 tb, 0.5)
    torch.cuda.synchronize()
    ncells = tabs.nd.shape[0]
    what = f"kernel 5 ({ncells} leaves)"
    require(int(f_p.sum()) > B // 2, f"{what} test rays interact")
    require(bool(torch.equal(f_k, f_p)), f"{what} found identical")
    s_err = float((s_k[f_k] - s_p[f_p]).abs().max())
    require(s_err <= 1e-5 * tabs.h[0], f"{what} s_int error {s_err}")
    require(bool(torch.equal(c_k, c_p)), f"{what} interaction cells equal")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-5 * rf_max,
            f"{what} rf error {rf_err} <= 1e-5 * {rf_max}")

    # timings on the launch alone: plain version first, then free its tensors
    dep = (tabs, pos, dirn, g, smin, smax, sub_p, cell_p, lum, tau_int, tb,
           0.5)
    pms5 = cuda_ms(lambda: ml._deposit_plain(*dep), reps=3)
    del sub_p, cell_p, rf_p, dep
    dep = (tabs, pos, dirn, g, smin, smax, sub_k, cell_k, lum, tau_int, tb,
           0.5)
    torch.cuda.empty_cache()
    ms5 = cuda_ms(lambda: ml._deposit_cuda(*dep))
    dms5 = device_ms(lambda: ml._deposit_cuda(*dep))["ours"]
    act_int = active & (tot > 1e-6)
    ms_pass2_rf = cuda_ms(lambda: ml.sweep_deposit(
        tabs, pos, dirn, active, sub_k, cell_k, lum, tau_int, tb, 0.5,
        lane=lane))
    # the no-RF pass 2 as the parent's loop called it, and with pass 1's
    # lane range and step sums
    resolve = lambda: ml.resolve_interaction(tabs, pos, dirn, act_int, sub_k,
                                             tb, tau_int)
    step_sums = torch.sum(sub_k, dim=1)
    resolve_lane = lambda: ml.resolve_interaction(
        tabs, pos, dirn, act_int, sub_k, tb, tau_int, lane=lane,
        dtau_step=step_sums)
    for a, b in zip(resolve(), resolve_lane()):
        require(bool(torch.equal(a, b)),
                "resolve_interaction with pass 1's lane and step sums")
    ms_resolve = cuda_ms(resolve)
    d_res, d_lane = device_ms(resolve), device_ms(resolve_lane)
    n_live = k4["live_pairs"]
    rec = tabs.n_steps * 3 * B * 4
    return dict(
        max_abs_err=rf_err, rf_max=rf_max, s_int_err=s_err, ms=ms5,
        device_ms=dms5, plain_ms=pms5, library_ms=None,
        ms_pass2_rf=ms_pass2_rf, ms_resolve_interaction=ms_resolve,
        resolve_interaction_device_ms=d_res["all"],
        resolve_interaction_launches=d_res["launches"],
        resolve_interaction_lane_ms=cuda_ms(resolve_lane),
        resolve_interaction_lane_device_ms=d_lane["all"],
        resolve_interaction_lane_launches=d_lane["launches"],
        leaves=ncells, shared_table=ncells <= ml.SHARED_LEAVES,
        live_pairs=n_live, live_share=n_live / (tabs.n_steps * B),
        # the whole record read, as the one-thread-per-pair design read it
        bound_full_record_ms=bound(
            lane_bytes(B, 0) + 8 * B + 2 * rec + rec // 3
            + 2 * tabs.n_steps * 4 + ncells * 4 + 8 * B, 0)["bound_ms"],
        **bound(lane_bytes(B, 0) + 8 * B + n_live * (3 * 4 + 3 * 4 + 4)
                + 2 * tabs.n_steps * 4 + ncells * 4 + 8 * B,
                n_live * (OPS_SLAB + 3 + 3 * (OPS_SUB + OPS_DEP))))


def phase_kernels_ml(torch) -> dict:
    """Kernels 4 and 5 against their plain versions at B = 65536 through
    their public wrappers: kernel 4 on bench_config3ism's tree (the
    full_width_ml path) and on bench_config3ismxl's (full_width_ml_large:
    a 256^3 raster whose leaf map exceeds L2), kernel 5 on both (rf_ml;
    the large tree's 138,447 leaves take the kernel's global path, the
    small tree's 5,230 its shared-memory table); then timings, with
    resolve_interaction (pass 2 of the path without an RF) beside kernel
    5."""
    sim_l, _, _ = config3ism("cuda", "config3ismxl")
    rs = np.random.default_rng(5)
    large, large_more, rays, lanes, rec_k, rec_p = _dtau_ml(torch, sim_l, rs)
    large5 = _deposit_ml(torch, sim_l, rs, large, rays, lanes, rec_k, rec_p)
    del sim_l, rays, lanes, rec_k, rec_p
    torch.cuda.empty_cache()
    sim, _, _ = config3ism("cuda")
    rs = np.random.default_rng(4)
    k4, more, rays, lanes, rec_k, rec_p = _dtau_ml(torch, sim, rs)
    k5 = _deposit_ml(torch, sim, rs, k4, rays, lanes, rec_k, rec_p)
    out = {"mlsweep_dtau": k4, "mlsweep_deposit": k5, **more}
    for name, big in (("mlsweep_dtau", large), ("mlsweep_deposit", large5),
                      *large_more.items()):
        out[name]["large_tree"] = big
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       big["max_abs_err"])
    emit({"phase": "kernels_ml", "batch": B_ML, **out})
    return out


def ml_problem(device, num_packets=16384, batch_size=4096):
    """The density octree of tests/test_mlsweep.py:30-47 (max_level 4) with
    a one-bin RF and a 64x64 frame, through the port's API."""
    from skirt9_tpu_torch.grids.octree import build_octree
    from skirt9_tpu_torch.instruments.distant import DistantInstrumentCfg
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.simulation import Simulation
    from skirt9_tpu_torch.sources.base import PointSource
    from skirt9_tpu_torch.transport.lifecycle import TransportOptions

    sigma = 1e-24

    def dens(p):
        r = np.linalg.norm(p, axis=-1)
        return np.where(r < PC, (PC / np.maximum(r, 0.1 * PC)) ** 2, 0.0)

    grid = build_octree(((-1.2 * PC, 1.2 * PC),) * 3, dens, max_level=4,
                        min_level=1, max_fraction=2e-2)
    nd = dens(grid.cell_centers().double().numpy()) / (sigma * PC)
    med = msys.make_medium(grid, nd.astype(np.float32),
                           np.array([0.4e-6, 0.7e-6]),
                           sigma_ext=np.full((1, 2), sigma),
                           albedo=np.full((1, 2), 0.5), g=np.full((1, 2), 0.3))
    inst = DistantInstrumentCfg(name="i", wave_borders=(0.5e-6, 0.6e-6),
                                distance=100 * PC, npx=64, npy=64,
                                fovx=4 * PC, fovy=4 * PC)
    return Simulation(grid=grid, medium=med,
                      sources=[PointSource(luminosity=1.0, lam0=0.55e-6)],
                      instruments=[inst],
                      options=TransportOptions(max_steps=grid.max_steps(),
                                               max_events=16),
                      rf_borders=np.array([0.5e-6, 0.6e-6]),
                      num_packets=num_packets, batch_size=batch_size, seed=4,
                      device=device)


def phase_draw_for_draw_ml(torch) -> None:
    """The port on the CPU (plain versions) against the port on the GPU
    (kernels 4-5), the same seed, on a density octree with a one-bin RF."""
    runs = {}
    for device in ("cpu", "cuda"):
        sim = ml_problem(device)
        require(type(sim._sweep_tabs).__name__ == "MLTables",
                "the density octree builds MLTables")
        rf, accs = sim.run_primary(verbose=False)
        runs[device] = (sim, rf, accs)
    (sc, rfc, ac), (sg, rfg, ag) = runs["cpu"], runs["cuda"]
    sed_c, sed_g = _sed(sc, ac), _sed(sg, ag)
    worst = 0.0
    for kind in ("transparent", "primarydirect", "primaryscattered", "total"):
        require(sed_c[kind][0] > 0, f"{kind} SED positive")
        e = abs(sed_g[kind][0] - sed_c[kind][0]) / sed_c[kind][0]
        require(e <= 1e-4, f"draw-for-draw (octree) {kind} SED {e} <= 1e-4")
        worst = max(worst, e)
    fc = ac[0]["frame"].double()
    fg = ag[0]["frame"].double().cpu()
    fe = float((fg - fc).abs().max() / fc.abs().max())
    require(fe <= 1e-3, f"draw-for-draw (octree) frame {fe} <= 1e-3 of max")
    tc, tg = float(rfc.double().sum()), float(rfg.double().sum())
    e_rf = abs(tg - tc) / tc
    require(tc > 0 and e_rf <= 1e-4, f"draw-for-draw (octree) RF total {e_rf}")
    emit({"phase": "draw_for_draw_ml", "leaves": sc.grid.ncells,
          "fine_grid": list(sc._sweep_tabs.n), "packets": sc.num_packets,
          "batch": sc.batch_size, "sed_rel_err": worst, "frame_err": fe,
          "rf_total_rel_err": e_rf,
          "rf_cell_err": float((rfg.double().cpu() - rfc.double()).abs().max()
                               / rfc.abs().max())})


def phase_full_width_ml(torch, smi: str, phase="full_width_ml",
                        name="config3ism", store_rf=False):
    """A clumpy-ISM tree at full width, timed after one warm-up run, with
    the correctness gates. The level-9 tree (`config3ismxl9`) runs on its
    voxel raster through the XL contracts (kernels 6-7 with the cell map),
    the others on the multi-level sweep (kernels 4-5)."""
    sim, t_tree, t_setup = config3ism("cuda", name, store_rf=store_rf)
    tabs = sim._sweep_tabs
    raster = name == "config3ismxl9"
    require(type(tabs).__name__ == ("XLTables" if raster else "MLTables")
            and (not raster or tabs.cellmap is not None),
            f"{name} builds its engine's tables")
    one_batch(sim, sim.run_primary)            # warm-up
    must = ML_PASS1 + DETECT + (("mlsweep_deposit",) if store_rf else ())
    must_not = RESIDENT + XL + NOT_PATH + (() if store_rf
                                           else ("mlsweep_deposit",))
    if raster:
        must, must_not = XL + DETECT, RESIDENT + ML + NOT_PATH
    (rf, accs), launches = drive(must, must_not,
                                 lambda: sim.run_primary(verbose=False))
    stats = dict(sim.last_stats)
    sed = _sed(sim, accs)
    cfg = sim.instruments[0]
    dlam = cfg.wave_borders[1] - cfg.wave_borders[0]
    expect = 1.0 / (4.0 * math.pi * cfg.distance ** 2 * dlam)
    e_tr = abs(sed["transparent"][0] - expect) / expect
    require(e_tr <= 1e-5, f"transparent SED {e_tr} <= 1e-5 of L/(4 pi d^2)")
    # tau from the centre to the box face along +z: nd sigma pc = 0.5
    ratio = sed["primarydirect"][0] / sed["transparent"][0]
    e_dir = abs(ratio - math.exp(-0.5))
    require(e_dir <= 1e-3, f"direct/transparent {ratio} vs exp(-0.5) "
            "within 1e-3")
    require(sed["R"][0] < 0.01, f"SED relative error R {sed['R'][0]} < 0.01")
    res = {"phase": phase, "config": name, "leaves": sim.grid.ncells,
           "fine_grid": list(tabs.n), "tables": type(tabs).__name__,
           "n_steps": getattr(tabs, "n_steps", None),
           "levels": len(getattr(tabs, "levels", ())), "tree_build_s": t_tree,
           "setup_s": t_setup, "packets": sim.num_packets,
           "batch": sim.batch_size, "packets_per_s": sim.last_rate,
           "seconds": stats["seconds"], "events": stats["events"],
           "sync_wait_s": stats["sync_s"], "launches": launches,
           "transparent_rel_err": e_tr, "direct_over_transparent": ratio,
           "exp_minus_tau": math.exp(-0.5), "R": float(sed["R"][0]),
           "scattered_over_transparent":
           float(sed["primaryscattered"][0] / sed["transparent"][0]),
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    if name == "config3ismxl":
        res["reference_engine"] = ("the XL fine raster "
                                   "(sweepxl.build_tree_tables)")
    if store_rf:
        require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0
                and float(rf.sum()) > 0 and rf.shape == (sim.grid.ncells, 1),
                "tree RF per leaf, finite and positive")
        res["rf_total"] = float(rf.double().sum())
        res["leaves_lit"] = int((rf[:, 0] > 0).sum())
    emit(res)
    return sim, launches


def phase_breakdown_ml(torch, sim) -> None:
    """One more run of a tree path under torch.profiler: device kernels,
    their launches per event, stream syncs and host-to-device copies, the
    device's busy and idle shares of the wall, and the kernels that take the
    most device time."""
    from skirt9_tpu_torch.tools import event_profile as ep
    prof = ep.profile_run(torch, lambda: sim.run_primary(verbose=False))
    events = sim.last_stats["events"]
    require(prof["loop_ranges"] > 0 and prof["loop"]["h2d_copies"] == 0,
            f"no host-to-device copy in the event loop: {prof['loop']}")
    emit({"phase": "breakdown_ml", "profiled_wall_s": prof["wall_s"],
          "device_busy_s": prof["busy_s"], "idle_share": prof["idle_share"],
          "device_launches": prof["whole"]["device_ops"], "events": events,
          "per_event": ep.per_event(prof, events),
          "unattributed": prof["unattributed"], "top": prof["top"]})


# ------------------------------------------------------- config 2, probes

PROBE = ("probe_gather_smem", "probe_gather_l2", "probe_scatter_smem",
         "row_lookup_gather", "row_lookup_select")


def phase_kernels_probe(torch) -> dict:
    """Kernels 8-9 through their entry points (the tools' `run`, at the
    original scripts' shapes), then each variant once more against its
    plain version (gathers and the row lookups bit-exact, sums within 1e-6
    relative) with its bound; kernel 3 at the probe's scatter shape beside
    kernel 8's. Then the parent's designs and the variants of
    perf/kernel8_variants.py and perf/kernel9_variants.py in turns with the
    package's kernels, the launch floor (an empty kernel, plainly and as a
    cluster of one), gather and scatter-add rates through block-local and
    distributed shared memory and L2, and the host cost of the parent's
    per-call launch set-up."""
    from perf import kernel8_variants as k8v
    from perf import kernel9_variants as k9v
    from skirt9_tpu_torch.ops import scatteradd as sca
    from skirt9_tpu_torch.tools import gather_probe as gp
    from skirt9_tpu_torch.tools import sublane_gather as sg
    (r8, r9), launches = drive(PROBE + ("scatter_add",),
                               RESIDENT + XL + ML + DETECT, lambda: (
                                   gp.run("cuda"), sg.run("cuda")))
    dev = torch.device("cuda")
    nd, idx, vals = gp.inputs(dev)
    tab, ix = sg.inputs(dev)
    g_ref = gp.gather_plain(nd, idx)
    s_ref = gp.scatter_plain(idx, vals, gp.N)
    l_ref = sg.lookup_plain(tab, ix)
    checks = {
        "probe_gather_smem": (gp.gather(nd, idx), g_ref, True),
        "probe_take_smem": (gp.take(nd, idx), g_ref, True),
        "probe_gather_l2": (gp.gather(nd, idx, staged=False), g_ref, True),
        "probe_scatter_smem": (gp.scatter(idx, vals, gp.N), s_ref, False),
        "scatter_add_probe_shape": (sca.scatter_add(idx, vals, gp.N), s_ref,
                                    False),
        "row_lookup_gather": (sg.lookup(tab, ix), l_ref, True),
        "row_lookup_select": (sg.lookup(tab, ix, select=True), l_ref, False)}
    torch.cuda.synchronize()
    err = {}
    for name, (got, ref, exact) in checks.items():
        err[name] = float((got - ref).abs().max())
        if exact:
            require(bool(torch.equal(got, ref)), f"{name} bit-exact")
        else:
            require(err[name] <= 1e-6 * float(ref.abs().max()),
                    f"{name} error {err[name]} <= 1e-6 relative")
    dev_t = {name: device_ms(fn) for name, fn in {
        "probe_gather_smem": lambda: gp.gather(nd, idx),
        "probe_gather_l2": lambda: gp.gather(nd, idx, staged=False),
        "probe_scatter_smem": lambda: gp.scatter(idx, vals, gp.N),
        "scatter_add": lambda: sca.scatter_add(idx, vals, gp.N),
        "row_lookup_gather": lambda: sg.lookup(tab, ix),
        "row_lookup_select": lambda: sg.lookup(tab, ix, select=True),
        "gather_library": lambda: gp.gather_plain(nd, idx),
        "scatter_library": lambda: gp.scatter_plain(idx, vals, gp.N),
        "lookup_library": lambda: sg.lookup_library(tab, ix)}.items()}
    B, N = gp.B, gp.N
    io8 = N * 4 + B * 8                   # table or histogram, idx, out/vals
    R, S, W, IT = sg.R, sg.S, sg.W, sg.ITERS
    io9 = R * W * 4 + 2 * S * W * 4
    out = {
        "probe_gather_smem": dict(
            ms=r8["gather_smem"]["ms"], ms_take=r8["take_smem"]["ms"],
            plain_ms=r8["gather_plain_ms"], library_ms=r8["gather_plain_ms"],
            max_abs_err=max(err["probe_gather_smem"], err["probe_take_smem"]),
            **bound(io8, 0)),
        "probe_gather_l2": dict(
            ms=r8["gather_l2"]["ms"], plain_ms=r8["gather_plain_ms"],
            library_ms=r8["gather_plain_ms"],
            max_abs_err=err["probe_gather_l2"], **bound(io8, 0)),
        "probe_scatter_smem": dict(
            ms=r8["scatter_smem"]["ms"], plain_ms=r8["scatter_plain_ms"],
            library_ms=r8["scatter_plain_ms"],
            max_abs_err=err["probe_scatter_smem"],
            kernel3_ms=r8["scatter_kernel3"]["ms"],
            kernel3_max_abs_err=err["scatter_add_probe_shape"],
            **bound(io8, B)),
        "row_lookup_gather": dict(
            ms=r9["gather"]["ms"], plain_ms=r9["gather"]["plain_ms"],
            library_ms=r9["library_ms"], max_abs_err=err["row_lookup_gather"],
            **bound(io9, S * W * IT)),
        # a compare and an add per (lookup, row)
        "row_lookup_select": dict(
            ms=r9["select"]["ms"], plain_ms=r9["select"]["plain_ms"],
            library_ms=r9["library_ms"], max_abs_err=err["row_lookup_select"],
            **bound(io9, 2 * S * W * IT * R))}
    lib = {"probe_gather_smem": "gather_library",
           "probe_gather_l2": "gather_library",
           "probe_scatter_smem": "scatter_library",
           "row_lookup_gather": "lookup_library",
           "row_lookup_select": "lookup_library"}
    for name in PROBE:
        out[name].update(launches=launches[name],
                         device_ms=dev_t[name]["ours"],
                         device_ms_call=dev_t[name]["all"],
                         library_device_ms=dev_t[lib[name]]["all"])
    out["probe_scatter_smem"]["kernel3_device_ms"] = dev_t["scatter_add"][
        "ours"]
    # kernel 3 runs on no simulation path now, but in the probe's comparison
    out["probe_scatter_smem"]["kernel3_launches"] = launches["scatter_add"]
    k8 = k8v.measure(torch, cuda_ms, device_ms)
    out["row_lookup_gather"]["variants"] = k9v.measure(torch, tab, ix, IT,
                                                       cuda_ms, device_ms)
    out["probe_gather_smem"]["variants"] = k8["gather"]
    out["probe_scatter_smem"]["variants"] = k8["scatter"]
    for name in PROBE[:4]:
        out[name]["floor_ms"] = k8["floor"]["empty"]["device_ms"]
    emit({"phase": "kernels_probe", "table": N, "indices": B,
          "row_table": [R, W], "index_rows": S, "iters": IT,
          "floor": k8["floor"], "rates": k8["rates"],
          "rate_rounds": k8v.ROUNDS, "host": k8["host"], **out})
    return out


def first_event_b2(torch, sim):
    """Config 2's first event as the path sees it: the first stratified
    batch of the primary source launched, its cross sections, the lane
    set-up of the sweep and the pass-1 optical depths."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.sources import base as src
    from skirt9_tpu_torch.transport import sweep as sw
    strata = sim._strata_for(sim.sources[0], sim.options)
    B, stabs, opts, lanes = sim._stratify(strata, sim._src_tabs[0],
                                          sim.options, sim.num_packets)
    pkt = src.launch_batch(sim.sources[0], stabs, sim.grid,
                           rng.seed_key(sim.seed, sim.device), lanes,
                           sim.num_packets)
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T.contiguous()
    tabs = sim._sweep_tabs
    g, smin, smax, sg_ = sw._prep(tabs, pkt.pos, pkt.dir, sig, pkt.alive)
    dtau = sw._dtau_plain(tabs, pkt.pos, pkt.dir, g, smin, smax, sg_)
    return pkt, opts, (g, smin, smax, sg_), dtau


def phase_kernels_b2(torch) -> dict:
    """Kernel 2 with config 2's 32 lane groups and kernel 3 on its
    163,840-bin frame, each against its plain version on config 2's first
    event, timed, with their bounds."""
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.ops import scatteradd as sca
    from skirt9_tpu_torch.transport import sweep as sw
    sim = config2("cuda")
    tabs = sim._sweep_tabs
    pkt, opts, (g, smin, smax, sg_), dtau = first_event_b2(torch, sim)
    B, n_groups = pkt.lam.shape[0], opts.rf_strata
    require(n_groups == 32 and B == B_FULL,
            f"config 2 runs 32 lane groups of a 2^17 batch ({n_groups}, {B})")
    rs = np.random.default_rng(6)
    grp = sw.dominant_axis(tabs, pkt.dir)
    tb, tot = sw.slab_prefix(dtau, pkt.dir.gather(1, grp[:, None])[:, 0] > 0)
    inv_sqrt = 1.0 / math.sqrt(sim.rf_scale)
    rfb = sim._rf_borders_dev
    in_rf = (pkt.lam >= rfb[0]) & (pkt.lam < rfb[-1])
    lum_half = (pkt.lum * (pkt.alive & in_rf)) * inv_sqrt
    u = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                     device=sim.device)
    tau_int = u * tot
    scale = (lum_half[None, :] * torch.exp(-tb)) * inv_sqrt
    rel = tau_int[None, :] - tb
    nbins = len(sim.rf_borders) - 1
    bin_map = torch.tensor(opts.rf_bin_map, dtype=torch.int32,
                           device=sim.device)
    dep = {"sweep_deposit": (sw._deposit_cuda, sw._deposit_plain, (
               tabs, pkt.pos, pkt.dir, g, smin, smax, sg_, scale, rel,
               n_groups)),
           "sweep_deposit_prefix": (
               sw._deposit_prefix_cuda, sw._deposit_prefix_plain, (
                   tabs, pkt.pos, pkt.dir, g, smin, smax, sg_, lum_half,
                   tau_int, tb, inv_sqrt, n_groups, bin_map, nbins))}
    n_act = active_slabs(tabs, pkt.pos, pkt.dir, g, smin, smax)
    out = {}
    for name, (kern, plain, args) in dep.items():
        res = check_deposit(torch, f"{name} (config 2)", kern, plain, args,
                            float(tabs.h[0]))
        rf_k = res.pop("outputs")[0]
        rows = nbins if name == "sweep_deposit_prefix" else n_groups
        require(rf_k.shape == (rows, tabs.nd.shape[0])
                and res["rf_rows_lit"] >= 25,
                f"{name} fills the 25 RF bins' rows ({res['rf_rows_lit']})")
        out[name] = dict(res, n_groups=n_groups,
                         **deposit_bound(name, tabs, B, n_act, rows))
    _, s_p, _, f_p = sw._deposit_plain(*dep["sweep_deposit"][2])

    # kernel 3: the frame bins of the first scattering peel-off, formed as
    # detect forms them from the interaction points found above
    cfg, itab = sim.instruments[0], sim._inst_tabs[0]
    nb = cfg.nbins
    ipos = pkt.pos + s_p[:, None] * pkt.dir
    b = torch.searchsorted(itab["wave_borders"], pkt.lam, right=True) - 1
    ok = f_p & (b >= 0) & (b < nb)
    ix, iy = dinst.frame_pixels(cfg, itab, ipos)
    ix, iy = ix.clamp(0, cfg.npx - 1), iy.clamp(0, cfg.npy - 1)
    size = nb * cfg.npy * cfg.npx
    flat = ((b.clamp(0, nb - 1) * cfg.npy + iy.long()) * cfg.npx
            + ix.long()).to(torch.int32)
    val = torch.where(ok, pkt.lum, torch.zeros_like(pkt.lum))
    k_ = sca.scatter_add(flat, val, size)
    p_ = sca.scatter_add_plain(flat, val, size)
    torch.cuda.synchronize()
    e3 = float((k_ - p_).abs().max())
    require(size == 163840 and e3 <= 1e-5 * float(p_.abs().max()),
            f"kernel 3 at {size} bins error {e3} <= 1e-5 relative")
    acc, f64 = torch.zeros(size, device=sim.device), flat.long()
    out["scatter_add"] = dict(
        max_abs_err=e3, bins=size, distinct_bins=int(torch.unique(flat).numel()),
        ms=cuda_ms(lambda: sca.scatter_add(flat, val, size)),
        plain_ms=cuda_ms(lambda: sca.scatter_add_plain(flat, val, size)),
        library_ms=cuda_ms(lambda: acc.index_add_(0, f64, val)),
        device_ms=device_ms(lambda: sca.scatter_add(flat, val, size))["ours"],
        library_device_ms=device_ms(
            lambda: acc.index_add_(0, f64, val))["all"],
        **bound(B * 8 + size * 4, B))
    # the detect kernel at config 2's shapes (40 SED bins, statistics, a
    # 40 x 64 x 64 frame): the first scattering peel-off, as above
    contrib = torch.tensor(rs.uniform(0.0, 1e-3, B), dtype=torch.float32,
                           device=sim.device)
    out["detect"] = check_detect(torch, cfg, itab, pkt.lam, ipos, contrib,
                                 f_p, 2)
    emit({"phase": "kernels_b2", "batch": B, "grid": list(tabs.n), **out})
    return out


def phase_draw_for_draw_b2(torch) -> None:
    """A small config 2 (8^3, 8,192 packets, 8 events, one self-absorption
    iteration) through run_with_dust_emission on the CPU (plain versions)
    and on the GPU (kernels), the same seed: each SED kind within 1e-4 of
    its largest bin, the RF within 1e-4 of its maximum, L_dust 1e-4."""
    runs = {}
    for device in ("cpu", "cuda"):
        sim = config2(device, num_packets=8192, batch_size=4096, n=8,
                      max_events=8, iterate_secondary=True, max_iterations=1)
        rf, accs, info = sim.run_with_dust_emission(verbose=False)
        runs[device] = (sim, rf, accs, info)
    (sc, rfc, ac, ic), (sg, rfg, ag, ig) = runs["cpu"], runs["cuda"]
    worst = 0.0
    sed_c, sed_g = ac[0]["sed"].double(), ag[0]["sed"].double().cpu()
    for k in range(sed_c.shape[0]):
        m = float(sed_c[k].abs().max())
        require(m > 0, f"SED kind {k} lit")
        worst = max(worst, float((sed_g[k] - sed_c[k]).abs().max()) / m)
    require(worst <= 1e-4, f"draw-for-draw (config 2) SEDs {worst} <= 1e-4")
    rf_err = float((rfg.double().cpu() - rfc.double()).abs().max()
                   / rfc.double().abs().max())
    require(rf_err <= 1e-4, f"draw-for-draw (config 2) RF {rf_err} <= 1e-4")
    e_l = abs(ig["L_dust"] / ic["L_dust"] - 1.0)
    require(ic["iterations"] == ig["iterations"] == 1 and e_l <= 1e-4,
            f"draw-for-draw (config 2) L_dust {e_l} <= 1e-4")
    emit({"phase": "draw_for_draw_b2", "grid": [8] * 3, "packets": 8192,
          "batch": sc.batch_size, "rf_bins": rfc.shape[1],
          "sed_err_of_max": worst, "rf_err_of_max": rf_err,
          "L_dust_rel_err": e_l, "iterations": ic["iterations"]})


def _golden_gates(sim, rf, accs, tmp) -> dict:
    """bench2's golden gates (`bench2_gates`) on a run's written SED file,
    its radiation field as mean intensity per cell and bin [W/m2/m/sr] and
    its dust temperature."""
    paths = sim.write_outputs(accs, "b2", tmp)
    dlam = np.diff(np.asarray(sim.rf_borders, np.float64))
    J = (rf.double().cpu().numpy() * sim.rf_scale
         / (4 * np.pi * sim.grid.volumes()[:, None] * dlam[None, :]))
    return bench2_gates(np.loadtxt(paths[0]), J, dlam,
                        sim.dust_temperature(rf)[:, 0])


def bench2_gates(ours, J, dlam, T, strict: bool = True) -> dict:
    """bench2's golden thresholds (tests/test_reference_parity.py:72-141)
    against tests/golden/bench2_*: SED column medians, the integrated
    total, the RF per-bin medians and log correlation, the dust
    temperature median. ours: the SED file's columns; J: (ncells, nbins)
    mean intensity [W/m2/m/sr]; dlam: the RF bin widths [m]; T: (ncells,)
    dust temperature [K]. strict False lists the gates missed under
    "missed" instead of failing (the goldens are SKIRT's at 32^3)."""
    missed = []

    def check(cond, what):
        if strict:
            require(cond, what)
        elif not cond:
            missed.append(what)

    ref = np.loadtxt(os.path.join(GOLDEN, "bench2_i0_sed.dat"))
    require(ours.shape[0] == ref.shape[0], "40 SED rows")
    require(bool(np.allclose(ours[:, 0], ref[:, 0], rtol=1e-3)),
            "SED wavelengths")
    res = {}
    for col, name, tol in ((2, "transparent", 0.05), (3, "primarydirect", 0.1),
                           (4, "primaryscattered", 0.25),
                           (5, "secondarydirect", 0.25)):
        hi = ref[:, col] > 0.05 * ref[:, col].max()
        med = float(np.median(ours[hi, col] / ref[hi, col]))
        check(abs(med - 1.0) < tol, f"bench2 {name} median ratio {med}")
        res[f"{name}_median_ratio"] = med
    lam = ref[:, 0]
    tot = float(np.trapezoid(ours[:, 1], lam) / np.trapezoid(ref[:, 1], lam))
    check(abs(tot - 1.0) < 0.1, f"bench2 integrated total ratio {tot}")
    res["total_ratio"] = tot
    with gzip.open(os.path.join(GOLDEN, "bench2_rf_J.dat.gz"), "rt") as f:
        refJ = np.loadtxt(f)[:, 1:]
    oursJ = J * 1e-6                      # per micron, as the golden
    tr, to = refJ.sum(axis=0), oursJ.sum(axis=0)
    hi = tr > 0.02 * tr.max()
    med = float(np.median(to[hi] / tr[hi]))
    check(abs(med - 1.0) < 0.1, f"bench2 RF per-bin median ratio {med}")
    bol_r = (refJ * dlam[None, :] * 1e6).sum(axis=1)
    bol_o = (oursJ * dlam[None, :] * 1e6).sum(axis=1)
    sel = bol_r > np.percentile(bol_r, 50)
    cc = float(np.corrcoef(np.log(bol_r[sel]),
                           np.log(np.maximum(bol_o[sel], 1e-300)))[0, 1])
    check(cc > 0.93, f"bench2 RF log correlation {cc} > 0.93")
    T_ref = np.loadtxt(os.path.join(GOLDEN, "bench2_T_dust_T.dat"))[:, 1]
    t_med = float(np.median(T[T_ref > 1.0] / T_ref[T_ref > 1.0]))
    check(abs(t_med - 1.0) < 0.05, f"bench2 dust temperature median {t_med}")
    res.update(rf_median_ratio=med, rf_log_correlation=cc,
               T_median_ratio=t_med)
    if not strict:
        res["missed"] = missed
    return res


def phase_full_width_b2(torch, smi: str):
    """Config 2 at bench.py's full width (2^20 packets in batches of 2^17,
    24 events, seed 0), a warm-up run and a timed run on the same object:
    kernels 1-2 and detect launched, no tree or XL kernel and not kernel
    3; bench2's golden gates and L_dust = L_abs_primary within 1e-4 (no
    iterations)."""
    sim = config2("cuda")
    one_batch(sim, sim.run_with_dust_emission)            # warm-up
    t0 = time.perf_counter()
    (rf, accs, info), launches = drive(
        RESIDENT + DETECT, XL + ML + NOT_PATH,
        lambda: sim.run_with_dust_emission(verbose=False))
    dt = time.perf_counter() - t0
    stats = dict(sim.last_stats)
    n_pk = sim.num_packets
    packets = n_pk * (1 + info["iterations"] + (1 if info["L_dust"] > 0 else 0))
    e_l = abs(info["L_dust"] / info["L_abs_primary"] - 1.0)
    require(not sim.iterate_secondary and info["iterations"] == 0
            and e_l < 1e-4, f"L_dust / L_abs_primary - 1 = {e_l} (< 1e-4)")
    require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0,
            "RF finite and non-negative")
    with tempfile.TemporaryDirectory() as tmp:
        gates = _golden_gates(sim, rf, accs, tmp)
    events = sum(seg[3] for seg in stats["segments"])
    res = {"phase": "full_width_b2", "grid": list(sim.grid.shape),
           "packets": n_pk, "batch": sim.batch_size, "rf_bins": rf.shape[1],
           "packets_per_s": packets / dt, "seconds": dt,
           "iterations": info["iterations"], "L_dust": info["L_dust"],
           "L_abs_primary": info["L_abs_primary"],
           "L_dust_rel_err": e_l,
           "segments": [{"name": n, "packets": p, "seconds": t, "events": e}
                        for n, p, t, e in stats["segments"]],
           "events": events, "launches": launches,
           "kernel_launches_per_event": sum(launches.values()) / events,
           **gates, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi}
    emit(res)
    return sim, launches


def phase_breakdown_b2(torch, sim) -> None:
    """Config 2 with one batch per segment (2^17 packets) under
    torch.profiler (host_per_event, on full_width_b2's simulation, which
    has run): launches, stream syncs and copies per event, busy and idle
    shares, the kernels that take the most device time."""
    sim.num_packets = B_FULL
    prof = host_per_event(
        torch, sim, lambda s: s.run_with_dust_emission(verbose=False),
        warm=True)
    emit({"phase": "breakdown_b2", "packets": B_FULL, **prof})


def config1h(device, num_packets=1 << 19, batch_size=B_FULL):
    """bench.py's config 1h (bench.py:108-126): tests/golden/bench1h.ski
    (radial tau 10, albedo 0.9) through the port's `load_ski`, 16 events
    per batch, run in lane-refill generations of 16 events."""
    from skirt9_tpu_torch.config.ski import load_ski
    sim = load_ski(os.path.join(GOLDEN, "bench1h.ski"),
                   num_packets=num_packets, batch_size=batch_size,
                   max_events=16, device=device)
    sim.refill_events = 16
    return sim


def edited_ski(name: str, directory, edits: dict, out: str = "small") -> str:
    """tests/golden/<name>.ski with each `old` replaced by `new`, written
    into directory beside copies of the input files it reads (the dust mix
    file, bench4's particles, sites and SSP table, bench7's SED and the
    X-ray gas's atomic data, which the loader reads beside the ski
    file)."""
    import re
    import shutil
    with open(os.path.join(GOLDEN, f"{name}.ski")) as f:
        text = f.read()
    for old, new in edits.items():
        require(old in text, f"{old!r} in {name}.ski")
        text = text.replace(old, new)
    path = os.path.join(str(directory), f"{out}.ski")
    with open(path, "w") as f:
        f.write(text)
    files = {"mrn_mean.txt", *re.findall(r'filename="([^"/]+)"', text)}
    if "XRayAtomicGasMix" in text:
        files |= {"XRay_PA.txt", "XRay_FL.txt"}
    for fn in files:
        if os.path.exists(os.path.join(GOLDEN, fn)):
            shutil.copy(os.path.join(GOLDEN, fn), str(directory))
    return path


def tree_edits(name: str, max_level: int, min_level: int = 2) -> dict:
    """The edit of tests/golden/<name>.ski that replaces its
    CartesianSpatialGrid by a density octree over the same box, levels
    min_level to max_level (DensityTreePolicy, maxDustFraction 1e-4)."""
    with open(os.path.join(GOLDEN, f"{name}.ski")) as f:
        text = f.read()
    start = text.index("<CartesianSpatialGrid")
    end = text.index("</CartesianSpatialGrid>") + len(
        "</CartesianSpatialGrid>")
    grid = text[start:end]
    head = grid[:grid.index(">")].replace("<CartesianSpatialGrid",
                                          "<PolicyTreeSpatialGrid")
    return {grid: f'{head} treeType="OctTree"><policy type="TreePolicy">'
            f'<DensityTreePolicy minLevel="{min_level}" maxLevel='
            f'"{max_level}" maxDustFraction="1e-4"/></policy>'
            '</PolicyTreeSpatialGrid>'}


# the reduced bench3: levels 2-4 (2,122 leaves on a 16^3 fine raster)
B3_SMALL = {'maxLevel="7"': 'maxLevel="4"'}


def config3(device, num_packets=1 << 18, batch_size=B_B3, max_events=24,
            path=None):
    """bench.py's config 3 (bench.py:130-149): tests/golden/bench3.ski
    through the port's `load_ski` (a tau_V = 10 r^-2 MRN shell on a
    density octree of levels 2-7, 55,574 leaves on a 128^3 fine raster; a
    25-bin RF in 32 lane groups, a 40-bin emission grid, self-absorption
    iterations), at bench_config3's 2^18 packets in batches of 2^16 and 24
    events. path: another ski file (the reduced one of `edited_ski`)."""
    from skirt9_tpu_torch.config.ski import load_ski
    return load_ski(path or os.path.join(GOLDEN, "bench3.ski"),
                    num_packets=num_packets, batch_size=batch_size,
                    max_events=max_events, device=device)


def golden_sed_gates(name, sed_um, gates) -> dict:
    """A one-bin SED [W/m2/micron] (transparent, primarydirect,
    primaryscattered) against tests/golden/<name>_i0_sed.dat: each entry of
    gates (kind, column, relative bound) as pytest.approx holds it."""
    golden = np.loadtxt(os.path.join(GOLDEN, f"{name}_i0_sed.dat"))
    res = {}
    for kind, col, tol in gates:
        ratio = sed_um[kind] / golden[col]
        require(abs(ratio - 1.0) <= tol,
                f"{name} {kind} {sed_um[kind]} vs golden {golden[col]} "
                f"within {tol}")
        res[f"{kind}_ratio"] = ratio
    return res


def bench1h_gates(sed) -> dict:
    """test_bench1h_high_tau_parity's gates
    (tests/test_reference_parity.py:149-178) on a calibrated SED."""
    sed_um = {k: float(sed[k][0]) * 1e-6 for k in (
        "transparent", "primarydirect", "primaryscattered")}
    res = golden_sed_gates("bench1h", sed_um, (
        ("transparent", 2, 2e-3), ("primarydirect", 3, 0.3),
        ("primaryscattered", 4, 0.1)))
    golden = np.loadtxt(os.path.join(GOLDEN, "bench1h_i0_sed.dat"))
    lr = math.log(sed_um["primarydirect"] / sed_um["transparent"])
    lr_g = math.log(golden[3] / golden[2])
    require(abs(lr / lr_g - 1.0) <= 0.02,
            f"bench1h log(direct/transparent) {lr} vs {lr_g} within 2%")
    res["log_direct_over_transparent"] = lr
    return res


def refilled_batch(torch, sim):
    """The packet batch that the refill path hands to life_cycle in the
    first generation with holes: dead lanes (histories used up) beside
    lanes launched in that generation (its emit mask) and lanes of earlier
    generations. The run stops there. Returns (pkt, emit mask)."""
    from skirt9_tpu_torch.transport import lifecycle as lc
    real, seen = lc.life_cycle, []

    class Found(Exception):
        pass

    def spy(*args, **kw):
        pkt, fresh = args[5], kw["emit_mask"]
        if not bool(pkt.alive.all()) and bool((fresh & pkt.alive).any()) \
                and bool((pkt.alive & ~fresh).any()):
            seen.append((pkt, fresh))
            raise Found
        return real(*args, **kw)

    lc.life_cycle = spy
    try:
        sim.run_primary(verbose=False)
    except Found:
        pass
    finally:
        lc.life_cycle = real
    require(len(seen) == 1, "a refill generation with dead, fresh and old "
            "lanes")
    return seen[0]


def check_refilled_batch(torch, sim) -> dict:
    """Kernels 1, 2 and detect on a refilled batch (`refilled_batch`)
    against their plain versions on the same CUDA tensors: kernel 1's total
    (the +z peel-off) and prefix modes within 1e-6 of each lane's tau and
    the lane range bit for bit, kernel 2's prefix mode as `check_deposit`
    holds it (with an RF, so that the deposits run), and detect on the
    emission peel-off of the fresh lanes as `check_detect` holds it."""
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.transport import sweep as sw
    pkt, fresh = refilled_batch(torch, sim)
    tabs = sim._sweep_tabs
    B = pkt.lam.shape[0]
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T.contiguous()
    active = pkt.alive
    res = {"lanes": B, "dead": int((~active).sum()),
           "fresh": int((fresh & active).sum()),
           "old": int((active & ~fresh).sum())}
    kz = torch.zeros_like(pkt.dir)
    kz[:, 2] = 1.0
    rel_tot = rel_pre = 0.0
    for d_, hint in ((pkt.dir, None), (kz, 2)):
        args = (tabs, pkt.pos, d_, sig, active, hint)
        t_k, t_p = sw.sweep_tau_total(*args), sw.sweep_tau_total_plain(*args)
        tb_k, tot_k, lane_k = sw.sweep_dtau_prefix(*args)
        tb_p, _, lane_p = sw.sweep_dtau_prefix_plain(*args)
        torch.cuda.synchronize()
        scale = t_p.clamp_min(1e-30)
        rel_tot = max(rel_tot, float(((t_k - t_p).abs() / scale).max()),
                      float(((tot_k - t_p).abs() / scale).max()))
        rel_pre = max(rel_pre,
                      float(((tb_k - tb_p).abs() / scale[None, :]).max()))
        for a, b, name in zip(lane_k, lane_p, ("axis", "smin", "smax")):
            require(bool(torch.equal(a, b)),
                    f"refilled batch: kernel 1 lane {name} bit-identical")
        require(bool(torch.equal(t_p[~active], torch.zeros_like(
            t_p[~active]))), "refilled batch: dead lanes see no dust")
    require(rel_tot <= 1e-6 and rel_pre <= 1e-6,
            f"refilled batch: kernel 1 totals {rel_tot} and prefix "
            f"{rel_pre} within 1e-6 of each lane's tau")
    res.update(kernel1_err_of_tau=max(rel_tot, rel_pre))
    tb, tot, lane = sw.sweep_dtau_prefix(tabs, pkt.pos, pkt.dir, sig, active)
    rs = np.random.default_rng(11)
    tau_int = torch.tensor(rs.uniform(size=B).astype(np.float32),
                           device=tot.device) * tot
    # the event loop's RF scaling (the sim's rf_scale), as if it stored one
    inv_sqrt = 1.0 / math.sqrt(sim.rf_scale)
    lum_half = (pkt.lum * active) * inv_sqrt
    dep = check_deposit(
        torch, "refilled sweep_deposit_prefix",
        lambda *a: sw.sweep_deposit_prefix(*a, nbins=1),
        lambda *a: sw.sweep_deposit_prefix_plain(*a, nbins=1),
        (tabs, pkt.pos, pkt.dir, sig, active, lum_half, tau_int, tb,
         inv_sqrt, lane), float(tabs.h[0]))
    res["kernel2"] = {k: dep[k] for k in ("max_abs_err", "rf_max",
                                          "found_agreement", "s_int_err")}
    cfg = sim.instruments[0]
    det = check_detect(torch, cfg, sim._inst_tabs[0], pkt.lam, pkt.pos,
                       pkt.lum / (4 * math.pi), fresh & active,
                       dinst.KIND_TRANSPARENT)
    res["detect"] = {k: det[k] for k in ("max_abs_err", "max_err_of_max",
                                         "lit_lanes")}
    return res


def phase_refill_b1h(torch, smi: str) -> dict:
    """Config 1h (bench1h.ski at bench.py's size: 2^19 packets in batches
    of 2^17, refill generations of 16 events), timed after a warm-up:
    kernels 1-2 and detect launched, no tree or XL kernel; no lane
    abandoned at the generation cap; bench1h's golden gates; kernels 1, 2
    and detect on a refilled batch against their plain versions; one
    batch of 2^17 packets (all its generations) profiled (host_per_event)."""
    sim = config1h("cuda")
    require(type(sim._sweep_tabs).__name__ == "SweepTables",
            "bench1h builds SweepTables")
    one_batch(sim, sim.run_primary)            # warm-up
    (_, accs), launches = drive(RESIDENT + DETECT, XL + ML + NOT_PATH,
                                lambda: sim.run_primary(verbose=False))
    st, rate = dict(sim.last_stats), sim.last_rate
    require(st["abandoned"] == 0, f"refill: {st['abandoned']} lanes "
            "abandoned at the generation cap")
    gates = bench1h_gates(_sed(sim, accs))
    n_full = sim.num_packets
    kernels = check_refilled_batch(torch, sim)
    sim.num_packets = B_FULL
    prof = host_per_event(torch, sim, lambda s: s.run_primary(verbose=False),
                          warm=True)
    sim.num_packets = n_full
    res = {"phase": "refill_b1h", "grid": list(sim.grid.shape),
           "packets": sim.num_packets, "batch": sim.batch_size,
           "refill_events": sim.refill_events,
           "packets_per_s": rate, "seconds": st["seconds"],
           "generations": st["generations"], "events": st["events"],
           "events_per_generation": st["events"] / st["generations"],
           "syncs": st["syncs"],
           "syncs_per_generation": st["syncs"] / st["generations"],
           "sync_wait_s": st["sync_s"], "abandoned": st["abandoned"],
           "launches": launches, **gates, "refilled_batch": kernels,
           "profiled_batch": B_FULL, "profile": prof,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit(res)
    return launches


# the CLI's packets for bench3.ski: bench_config3's 2^18 (the ski file says
# 10^6), so that the call stays well inside its time limit
CLI_B3_PACKETS = 1 << 18


def phase_cli(torch, smi: str) -> dict:
    """`skirt9_tpu_torch.__main__.main` on bench1.ski, bench2.ski and
    bench4.ski at their own 10^6 packets and on bench3.ski at 2^18 packets
    (`CLI_B3_PACKETS`), bench5.ski and its static copy at 2 x 10^6, bench6.ski
    at 10^5 (128 events, `--max-events`) and bench7.ski at 10^6, in batches
    of 131,072, into a temporary directory,
    each driven with the launch counts set to 0: kernels 1-2 and detect
    launched for bench1 and bench2, kernels 4-5 and detect for bench3 and
    bench4. The gates read the written files: bench1's SED against
    test_bench1_parity_with_reference's thresholds, bench2's SED, RF and
    temperature probe files against bench2_gates, bench3's against
    bench3_gates, bench4's SED and temperature files against bench4_gates;
    the probe files hold one row per cell and equal the run's RF and dust
    temperature (and bench3's and bench4's cell properties their volumes
    and densities); bench6's and bench7's SED files through their golden gates
    (b67_file_gates)."""
    from skirt9_tpu_torch import __main__ as cli
    from skirt9_tpu_torch.probes import probes
    from skirt9_tpu_torch.utils.fits import read_fits
    real, runs = probes.run_probe_system, {}

    def spy(sim, when, prefix, outdir=".", rf=None):
        if when == "Run":
            runs[prefix] = (sim, rf)
        return real(sim, when, prefix, outdir, rf=rf)

    res = {"phase": "cli", "batch": 131072,
           "bench3_packets_flag": CLI_B3_PACKETS}
    launches = {}
    probes.run_probe_system = spy
    try:
        with tempfile.TemporaryDirectory() as tmp:
            static = edited_ski("bench5", tmp, B5_STATIC, out="bench5static")
            for name, must, extra in (
                    ("bench1", RESIDENT + DETECT, []),
                    ("bench2", RESIDENT + DETECT, []),
                    ("bench3", ML + DETECT, ["-p", str(CLI_B3_PACKETS)]),
                    ("bench4", ML + DETECT, []),
                    ("bench5", RESIDENT + DETECT, []),
                    ("bench5static", RESIDENT + DETECT, [])):
                must_not = tuple(k for k in RESIDENT + XL + ML + NOT_PATH
                                 if k not in must)
                t0 = time.perf_counter()
                ski = (static if name == "bench5static"
                       else os.path.join(GOLDEN, f"{name}.ski"))
                rc, launches[name] = drive(
                    must, must_not,
                    lambda: cli.main([ski, "-b", "131072", "-o", tmp,
                                      *extra]))
                require(rc == 0, f"CLI on {name}.ski exit code {rc}")
                res[f"{name}_wall_s"] = time.perf_counter() - t0
                sim = runs[name][0]
                res[f"{name}_packets"] = sim.num_packets
                res[f"{name}_run_s"] = sim.last_stats["seconds"]
                ours = np.loadtxt(os.path.join(tmp, f"{name}_i0_sed.dat"))
                cube, _ = read_fits(os.path.join(tmp,
                                                 f"{name}_i0_total.fits"))
                require(bool(np.isfinite(ours).all()
                             and np.isfinite(cube).all())
                        and cube.max() > 0, f"{name} outputs finite, lit")
            # configs 6 and 7: SED instruments (no frame); bench6's
            # resonant line at bench_config6's 128 events
            for name, extra in (("bench6", ["--max-events", "128"]),
                                ("bench7", [])):
                t0 = time.perf_counter()
                rc, launches[name] = drive(
                    RESIDENT + DETECT, XL + ML + NOT_PATH,
                    lambda: cli.main([os.path.join(GOLDEN, f"{name}.ski"),
                                      "-b", "131072", "-o", tmp, *extra]))
                require(rc == 0, f"CLI on {name}.ski exit code {rc}")
                res[f"{name}_wall_s"] = time.perf_counter() - t0
                sim = runs[name][0]
                res[f"{name}_packets"] = sim.num_packets
                res[f"{name}_run_s"] = sim.last_stats["seconds"]
                res[name] = b67_file_gates(
                    name, os.path.join(tmp, f"{name}_i0_sed.dat"),
                    strict_peak=False)
            require(runs["bench6"][0].num_packets == 10 ** 5
                    and runs["bench7"][0].num_packets == 10 ** 6,
                    "10^5 packets for bench6 and 10^6 for bench7, as the ski "
                    "files say")
            require(runs["bench1"][0].num_packets == 10 ** 6
                    and runs["bench2"][0].num_packets == 10 ** 6
                    and runs["bench3"][0].num_packets == CLI_B3_PACKETS
                    and runs["bench4"][0].num_packets == 10 ** 6
                    and runs["bench5"][0].num_packets == 2 * 10 ** 6,
                    "10^6 packets each for bench1, bench2 and bench4 and "
                    "2 x 10^6 for bench5, as the ski files say, and the "
                    "flag's for bench3")
            # bench5's gates from its files: the SED's Q, U, V columns and
            # the total and Stokes cubes, the static run's scattered column
            sed5, cube5, cube5_q, R5 = _b5_files(tmp, "bench5", None)
            sed5s = _b5_files(tmp, "bench5static", None)[0]
            res["bench5"] = dict(
                bench5_gates(sed5, sed5s["primaryscattered"]),
                frame=bench5_frame_gates(cube5, cube5_q, R5, strict=False))
            b1 = np.loadtxt(os.path.join(tmp, "bench1_i0_sed.dat"))
            res["bench1"] = golden_sed_gates(
                "bench1", {"transparent": b1[2], "primarydirect": b1[3],
                           "primaryscattered": b1[4]},
                (("transparent", 2, 2e-3), ("primarydirect", 3, 0.02),
                 ("primaryscattered", 4, 0.05)))
            for name, rf_file, T_file in (
                    ("bench2", "bench2_rf_radiationfield.dat",
                     "bench2_T_temperature.dat"),
                    ("bench3", "bench3_rf_radiationfield.dat",
                     "bench3_T_temperature.dat")):
                sim, rf = runs[name]
                J = np.loadtxt(os.path.join(tmp, rf_file))
                T = np.loadtxt(os.path.join(tmp, T_file))
                n = sim.grid.ncells
                require(J.shape == (n, 3 + rf.shape[1]) and T.shape == (n, 4),
                        f"{name} probe files: one row per cell")
                require(bool(np.array_equal(J[:, 3:],
                                            mean_intensity(sim, rf))),
                        f"the {name} RF probe file holds the run's RF")
                require(bool(np.array_equal(T[:, 3],
                                            sim.dust_temperature(rf)[:, 0])),
                        f"the {name} temperature probe file holds the run's "
                        "dust temperature")
                sed = np.loadtxt(os.path.join(tmp, f"{name}_i0_sed.dat"))
                if name == "bench2":
                    dlam = np.diff(np.asarray(sim.rf_borders, np.float64))
                    res[name] = bench2_gates(sed, J[:, 3:], dlam, T[:, 3])
                else:
                    res[name] = bench3_gates(sim, sed, J[:, 3:], T[:, 3])
            sim = runs["bench3"][0]
            cells = np.loadtxt(os.path.join(tmp, "bench3_cells_cellprops.dat"))
            require(cells.shape == (sim.grid.ncells, 5)
                    and bool(np.array_equal(cells[:, 3], sim.grid.volumes()))
                    and bool(np.array_equal(
                        cells[:, 4], sim.medium.nd[:, 0].double().cpu()
                        .numpy())),
                    "bench3's cell-properties file holds the leaves' "
                    "volumes and densities")
            # bench4: its Voronoi cells' probe files and the golden gates
            # from the written SED and temperature files
            sim, rf = runs["bench4"]
            cells = np.loadtxt(os.path.join(tmp, "bench4_cells_cellprops.dat"))
            T = np.loadtxt(os.path.join(tmp, "bench4_T_temperature.dat"))
            require(cells.shape == (2895, 5) and T.shape == (2895, 4)
                    and bool(np.array_equal(
                        cells[:, :3], sim.grid.sites.double().cpu().numpy()))
                    and bool(np.array_equal(cells[:, 3], sim.grid.volumes()))
                    and bool(np.array_equal(
                        cells[:, 4], sim.medium.nd[:, 0].double().cpu()
                        .numpy())),
                    "bench4's cell-properties file holds the sites, their "
                    "exact volumes and densities")
            require(bool(np.array_equal(T[:, 3],
                                        sim.dust_temperature(rf)[:, 0])),
                    "the bench4 temperature probe file holds the run's dust "
                    "temperature")
            res["bench4"] = bench4_gates(
                sim, np.loadtxt(os.path.join(tmp, "bench4_i0_sed.dat")),
                T[:, 3])
    finally:
        probes.run_probe_system = real
    res.update(launches=launches, device=torch.cuda.get_device_name(0),
               nvidia_smi=smi)
    emit(res)
    return launches


# ------------------------------------------------------------- config 3

ML_NOT_PATH = RESIDENT + XL + NOT_PATH


def first_event_b3(torch, sim):
    """Config 3's (or config 4's) first event as the tree path sees it (a
    Voronoi raster is a one-level tree): the first stratified
    batch of the primary source launched, and kernel 4's pass 1 on it (the
    record with leaf ids, step sums, prefix, total and lane range)."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.sources import base as src
    from skirt9_tpu_torch.transport import mlsweep as ml
    strata = sim._strata_for(sim.sources[0], sim.options)
    B, stabs, opts, lanes = sim._stratify(strata, sim._src_tabs[0],
                                          sim.options, sim.num_packets)
    pkt = src.launch_batch(sim.sources[0], stabs, sim.grid,
                           rng.seed_key(sim.seed, sim.device), lanes,
                           sim.num_packets)
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T.contiguous()
    return pkt, opts, ml.sweep_dtau_prefix(sim._sweep_tabs, pkt.pos, pkt.dir,
                                           sig, pkt.alive)


def phase_kernels_b3(torch) -> dict:
    """Kernel 5's grouped mode on config 3's first event (the full bench3
    tree, 55,574 leaves: the global path; 32 lane groups folded into the 25
    RF rows by the launch's bin map) against its plain version: the RF
    within 1e-6 of its maximum, s_int, icell and found equal. Timed by CUDA
    events and by device time, beside the plain version; its bound counts
    the lane inputs, the record at the (plan step, lane) pairs the rays
    cross, the plan, the bin map, the RF rows written and the first hits."""
    from skirt9_tpu_torch.transport import mlsweep as ml
    sim = config3("cuda")
    tabs = sim._sweep_tabs
    pkt, opts, (rec, cells, _, tb, tot, lane) = first_event_b3(torch, sim)
    B, n_groups = pkt.lam.shape[0], opts.rf_strata
    nbins = len(sim.rf_borders) - 1
    require(n_groups == 32 and B == B_B3 and nbins == 25,
            f"config 3 runs 32 lane groups of a 2^16 batch into 25 bins "
            f"({n_groups}, {B}, {nbins})")
    ncells = tabs.nd.shape[0]
    require(ncells > ml.SHARED_LEAVES, "bench3's tree takes the global path")
    rs = np.random.default_rng(8)
    inv_sqrt = 1.0 / math.sqrt(sim.rf_scale)
    rfb = sim._rf_borders_dev
    in_rf = (pkt.lam >= rfb[0]) & (pkt.lam < rfb[-1])
    lum_half = (pkt.lum * (pkt.alive & in_rf)) * inv_sqrt
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=sim.device) * tot
    bin_map = torch.tensor(opts.rf_bin_map, dtype=torch.int32,
                           device=sim.device)
    args = (tabs, pkt.pos, pkt.dir, pkt.alive, rec, cells, lum_half, tau_int,
            tb, inv_sqrt)
    kw = dict(n_groups=n_groups, lane=lane, bin_map=bin_map, nbins=nbins)
    rf_k, s_k, c_k, f_k = ml.sweep_deposit(*args, **kw)
    rf_p, s_p, c_p, f_p = ml.sweep_deposit_plain(*args, **kw)
    torch.cuda.synchronize()
    what = f"kernel 5, 32 groups ({ncells} leaves)"
    require(int(f_p.sum()) > B // 2, f"{what} test rays interact")
    require(bool(torch.equal(f_k, f_p)), f"{what} found identical")
    require(bool(torch.equal(s_k[f_k], s_p[f_p])), f"{what} s_int identical")
    require(bool(torch.equal(c_k, c_p)), f"{what} interaction cells equal")
    require(rf_k.shape == rf_p.shape == (nbins, ncells), f"{what} RF rows")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-6 * rf_max,
            f"{what} rf error {rf_err} <= 1e-6 * {rf_max}")
    rows_lit = int((rf_p.abs().sum(dim=1) > 0).sum())
    require(rows_lit == nbins, f"{what} fills the 25 bins' rows ({rows_lit})")
    g, smin, smax = lane
    dep = (tabs, pkt.pos, pkt.dir, g, smin, smax, rec, cells, lum_half,
           tau_int, tb, inv_sqrt, n_groups, bin_map, nbins)
    del rf_p
    plain_ms = cuda_ms(lambda: ml._deposit_plain(*dep), reps=3)
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: ml._deposit_cuda(*dep))
    dev_ms = device_ms(lambda: ml._deposit_cuda(*dep))["ours"]
    n_live = int(ml._plan_substeps(tabs, pkt.pos, pkt.dir, g, smin,
                                   smax)[3].sum())
    res = dict(max_abs_err=rf_err, rf_max=rf_max, err_of_max=rf_err / rf_max,
               n_groups=n_groups, rows=nbins, rows_lit=rows_lit,
               leaves=ncells, shared_table=False, live_pairs=n_live,
               live_share=n_live / (tabs.n_steps * B), ms=ms,
               device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
               **bound(lane_bytes(B, 0) + 8 * B
                       + n_live * (3 * 4 + 3 * 4 + 4)
                       + 2 * tabs.n_steps * 4 + n_groups * 4
                       + nbins * ncells * 4 + 8 * B,
                       n_live * (OPS_SLAB + 3 + 3 * (OPS_SUB + OPS_DEP))))
    emit({"phase": "kernels_b3", "batch": B, "fine_grid": list(tabs.n),
          "n_steps": tabs.n_steps, "mlsweep_deposit": res})
    return res


def phase_draw_for_draw_b3(torch) -> dict:
    """The reduced config 3 (bench3.ski at maxLevel 4: 2,122 leaves; 8,192
    packets in batches of 4,096, which the 32 lane groups round to one
    batch of 32,768 lanes a segment; 4 events; at most 2 self-absorption
    iterations) through run_with_dust_emission on the CPU (plain versions)
    and on the GPU (kernels 4, 5 and detect launched, no other sweep), the
    same seed: iterations equal, each SED kind and the RF within 2e-5 of
    their maxima, the frame within 1e-3 of its brightest pixel, L_dust
    within 1e-4."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = edited_ski("bench3", tmp, B3_SMALL)
        for device in ("cpu", "cuda"):
            sim = config3(device, num_packets=8192, batch_size=4096,
                          max_events=4, path=path)
            sim.max_iterations = 2
            run = lambda: sim.run_with_dust_emission(verbose=False)
            if device == "cuda":
                out, launches = drive(ML + DETECT, ML_NOT_PATH, run)
            else:
                out = run()
            runs[device] = (sim, *out)
    (sc, rfc, ac, ic), (sg, rfg, ag, ig) = runs["cpu"], runs["cuda"]
    require(ic["iterations"] == ig["iterations"] >= 1,
            f"draw-for-draw (config 3) iterations {ic['iterations']}, "
            f"{ig['iterations']}")
    worst = 0.0
    sed_c, sed_g = ac[0]["sed"].double(), ag[0]["sed"].double().cpu()
    for k in range(sed_c.shape[0]):
        m = float(sed_c[k].abs().max())
        require(m > 0, f"SED kind {k} lit")
        worst = max(worst, float((sed_g[k] - sed_c[k]).abs().max()) / m)
    require(worst <= 2e-5, f"draw-for-draw (config 3) SEDs {worst} <= 2e-5")
    rf_err = float((rfg.double().cpu() - rfc.double()).abs().max()
                   / rfc.double().abs().max())
    require(rf_err <= 2e-5, f"draw-for-draw (config 3) RF {rf_err} <= 2e-5")
    fc = ac[0]["frame"].double()
    fg = ag[0]["frame"].double().cpu()
    fe = float((fg - fc).abs().max() / fc.abs().max())
    require(fe <= 1e-3, f"draw-for-draw (config 3) frame {fe} <= 1e-3")
    e_l = abs(ig["L_dust"] / ic["L_dust"] - 1.0)
    require(e_l <= 1e-4, f"draw-for-draw (config 3) L_dust {e_l} <= 1e-4")
    res = {"phase": "draw_for_draw_b3", "leaves": sc.grid.ncells,
           "packets": 8192, "lanes": 32768, "rf_bins": rfc.shape[1],
           "iterations": ic["iterations"], "sed_err_of_max": worst,
           "rf_err_of_max": rf_err, "frame_err": fe, "L_dust_rel_err": e_l,
           "segments": [s[0] for s in sg.last_stats["segments"]],
           "launches": launches}
    emit(res)
    return res


def bench3_gates(sim, sed, J, T) -> dict:
    """bench3's golden thresholds (tests/test_reference_parity.py:185-269)
    against tests/golden/bench3_*: the SED column medians and the
    integrated total; the dust temperature at the reference octree's cell
    centres, median and mass-weighted mean; the radiation field's volume
    integral per bin. sed: the SED file's columns; J: (ncells, nbins) mean
    intensity [W/m2/m/sr]; T: (ncells,) dust temperature [K]."""
    import torch
    ref = np.loadtxt(os.path.join(GOLDEN, "bench3_i0_sed.dat"))
    require(sed.shape[0] == ref.shape[0], "40 SED rows")
    require(bool(np.allclose(sed[:, 0], ref[:, 0], rtol=1e-3)),
            "SED wavelengths")
    res = {}
    for col, name, tol in ((2, "transparent", 0.05), (3, "primarydirect", 0.2),
                           (4, "primaryscattered", 0.25),
                           (5, "secondarydirect", 0.25)):
        hi = ref[:, col] > 0.05 * ref[:, col].max()
        med = float(np.median(sed[hi, col] / ref[hi, col]))
        require(abs(med - 1.0) < tol, f"bench3 {name} median ratio {med}")
        res[f"{name}_median_ratio"] = med
    lam = ref[:, 0]
    tot = float(np.trapezoid(sed[:, 1], lam) / np.trapezoid(ref[:, 1], lam))
    require(abs(tot - 1.0) < 0.15, f"bench3 integrated total ratio {tot}")
    res["total_ratio"] = tot
    with gzip.open(os.path.join(GOLDEN, "bench3_cellprops.dat.gz"),
                   "rt") as f:
        props = np.loadtxt(f)
    T_ref = np.loadtxt(os.path.join(GOLDEN, "bench3_T_dust_T.dat"))[:, 1]
    rho = props[:, 6]                      # dust mass density
    idx = sim.grid.locate(torch.tensor((props[:, 1:4] * PC).astype(
        np.float32), device=sim.device)).cpu().numpy()
    ok = (idx >= 0) & (rho > 0) & (T_ref > 1.0)
    T_at = T[idx[ok]]
    med = float(np.median(T_at / T_ref[ok]))
    require(abs(med - 1.0) < 0.08, f"bench3 temperature median ratio {med}")
    w = (rho * props[:, 4])[ok]
    mw = float(np.sum(T_at * w) / np.sum(T_ref[ok] * w))
    require(abs(mw - 1.0) < 0.08, f"bench3 mass-weighted temperature {mw}")
    with gzip.open(os.path.join(GOLDEN, "bench3_rf_J.dat.gz"), "rt") as f:
        refJ = np.loadtxt(f)[:, 1:]
    JV = (J * sim.grid.volumes()[:, None]).sum(axis=0) * 1e-6  # per micron
    JV_ref = (refJ * (props[:, 4] * PC ** 3)[:, None]).sum(axis=0)
    hi = JV_ref > 0.02 * JV_ref.max()
    rf_med = float(np.median(JV[hi] / JV_ref[hi]))
    require(abs(rf_med - 1.0) < 0.1, f"bench3 RF volume integral {rf_med}")
    res.update(T_median_ratio=med, T_mass_weighted_ratio=mw,
               rf_volume_integral_median_ratio=rf_med,
               reference_cells_compared=int(ok.sum()))
    return res


def mean_intensity(sim, rf) -> np.ndarray:
    """(ncells, nbins) mean intensity [W/m2/m/sr] of a run's RF."""
    dlam = np.diff(np.asarray(sim.rf_borders, np.float64))
    return (rf.double().cpu().numpy() * sim.rf_scale
            / (4 * np.pi * sim.grid.volumes()[:, None] * dlam[None, :]))


def phase_full_width_b3(torch, smi: str):
    """Config 3 at bench_config3's width (bench.py:130-149: 2^18 packets in
    batches of 2^16, 24 events, seed 0), a warm-up run and a timed run on
    the same object: kernels 4, 5 and detect launched, kernels 1, 2, 6 and
    7 not; packets/s as bench.py counts them, packets x (1 + iterations +
    [L_dust > 0]); each segment's seconds and events; every gate of
    test_bench3_*."""
    sim = config3("cuda")
    require(type(sim._sweep_tabs).__name__ == "MLTables",
            "bench3 builds MLTables")
    one_batch(sim, sim.run_with_dust_emission)            # warm-up
    t0 = time.perf_counter()
    (rf, accs, info), launches = drive(
        ML + DETECT, ML_NOT_PATH,
        lambda: sim.run_with_dust_emission(verbose=False))
    dt = time.perf_counter() - t0
    stats = dict(sim.last_stats)
    n_pk = sim.num_packets
    packets = n_pk * (1 + info["iterations"] + int(info["L_dust"] > 0))
    require(sim.iterate_secondary and info["iterations"] >= 1,
            f"bench3 iterates ({info['iterations']})")
    require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0,
            "RF finite and non-negative")
    from skirt9_tpu_torch.utils.fits import read_fits
    with tempfile.TemporaryDirectory() as tmp:
        paths = sim.write_outputs(accs, "b3", tmp)
        sed = np.loadtxt(paths[0])
        cube, _ = read_fits(paths[1])
    require(cube.shape == (40, 64, 64) and bool(np.isfinite(cube).all())
            and cube.max() > 0, "frame FITS finite and lit")
    gates = bench3_gates(sim, sed, mean_intensity(sim, rf),
                         sim.dust_temperature(rf)[:, 0])
    events = sum(seg[3] for seg in stats["segments"])
    tabs = sim._sweep_tabs
    res = {"phase": "full_width_b3", "leaves": sim.grid.ncells,
           "fine_grid": list(tabs.n), "n_steps": tabs.n_steps,
           "packets": n_pk, "batch": sim.batch_size, "rf_bins": rf.shape[1],
           "packets_per_s": packets / dt, "seconds": dt,
           "iterations": info["iterations"], "L_dust": info["L_dust"],
           "L_abs_primary": info["L_abs_primary"],
           "L_dust_over_L_abs_primary": info["L_dust"] / info["L_abs_primary"],
           "segments": [{"name": n, "packets": p, "seconds": t, "events": e}
                        for n, p, t, e in stats["segments"]],
           "events": events, "launches": launches,
           "kernel_launches_per_event": sum(launches.values()) / events,
           **gates, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi}
    emit(res)
    return sim, launches, res


def phase_breakdown_b3(torch, sim) -> None:
    """Config 3 with one batch of 2^16 packets per segment under
    torch.profiler (host_per_event, on full_width_b3's simulation, which
    has run): device operations, stream syncs and host copies per event,
    busy and idle shares, the kernels that take the most device time."""
    sim.num_packets = B_B3
    prof = host_per_event(
        torch, sim, lambda s: s.run_with_dust_emission(verbose=False),
        warm=True)
    emit({"phase": "breakdown_b3", "packets": B_B3, **prof})


# -------------------------- XL grids with lane groups, trees on voxel rasters

# bench2.ski at 256^3: its three LinMesh meshes at 256 bins
B2_256 = {'numBins="32"': 'numBins="256"'}


def config2x256(device, num_packets=1 << 20, batch_size=B_FULL,
                max_events=24):
    """bench2.ski (bench.py:79-105) through the port's `load_ski` with its
    three LinMesh numBins set to 256: config 2 on a 256^3 grid (16.8 M
    cells), past the resident sweep's ceiling, so on the XL contracts, its
    25-bin RF filled by 32 lane groups. Everything else as the ski file
    says; 2^20 packets in batches of 2^17 and 24 events, as config 2."""
    from skirt9_tpu_torch.config.ski import load_ski
    with tempfile.TemporaryDirectory() as tmp:
        return load_ski(edited_ski("bench2", tmp, B2_256),
                        num_packets=num_packets, batch_size=batch_size,
                        max_events=max_events, device=device)


def first_event_xl(torch, sim):
    """A configuration's first event as the XL path sees it: the first
    batch of the first source launched (stratified where the RF has several
    bins), its cross sections, the lanes sorted as the loop sorts them
    (`lane_order` with the lane groups) and kernel 6's prefix mode on them.
    Returns (pos, dir, lam, lum, alive, sig) sorted, the options, the lane
    groups and (record, prefix, total, lane range)."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.sources import base as src
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    strata = sim._strata_for(sim.sources[0], sim.options)
    opts, stabs = sim.options, sim._src_tabs[0]
    lanes = torch.arange(sim.batch_size, dtype=torch.int64, device=sim.device)
    if strata is not None:
        _, stabs, opts, lanes = sim._stratify(strata, stabs, opts,
                                              sim.num_packets)
    pkt = src.launch_batch(sim.sources[0], stabs, sim.grid,
                           rng.seed_key(sim.seed, sim.device), lanes,
                           sim.num_packets)
    tabs = sim._sweep_tabs
    n_groups = max(opts.rf_strata, 1)
    perm = xl.lane_order(tabs, pkt.pos, pkt.dir,
                         sw.dominant_axis(tabs, pkt.dir), n_groups)
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T[:, perm]
    rays = (pkt.pos[perm], pkt.dir[perm], pkt.lam[perm], pkt.lum[perm],
            pkt.alive[perm], sig.contiguous())
    return rays, opts, n_groups, xl.sweep_dtau_prefix(
        tabs, rays[0], rays[1], rays[5], rays[4])


def check_grouped_xl(torch, what, sim, rays, pre, n_groups, bin_map,
                     nbins) -> dict:
    """Kernel 7's prefix mode with lane groups (and a cell map where the
    tables have one) against its plain version on one event: the RF
    within 1e-6 of its maximum (both sum in f64), s_int, icell and found
    identical. Then its time adding into an f64 accumulator, as the loop
    calls it, by CUDA events and device time; the device time of the form
    that sums into a fresh zero table and rounds it (what keeping a delta
    per event would cost); the plain version's time;
    the bound: the lane inputs, lum, tau_int and the mask, the prefix, the
    record at the crossed pairs of the depositing lanes and at the hit
    slab, the cell map there, the bin map, the RF entries this event
    reaches and the per-lane outputs."""
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    tabs = sim._sweep_tabs
    pos, dirn, lam, lum, alive, _ = rays
    rec, tb, tot, lane = pre
    B = pos.shape[0]
    rs = np.random.default_rng(12)
    inv_sqrt = 1.0 / math.sqrt(sim.rf_scale)
    rfb = sim._rf_borders_dev
    lum_half = (lum * (alive & (lam >= rfb[0]) & (lam < rfb[-1]))) * inv_sqrt
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=pos.device) * tot
    act_int = alive & (tot > 1e-6)
    args = (tabs, pos, dirn, act_int, rec, lum_half, tau_int, tb, inv_sqrt,
            lane)
    kw = dict(n_groups=n_groups, bin_map=bin_map, nbins=nbins)
    rf_k, *hit_k = xl.sweep_deposit_prefix(*args, **kw)
    rf_p, *hit_p = xl.sweep_deposit_prefix_plain(*args, **kw)
    torch.cuda.synchronize()
    require(int(hit_p[2].sum()) > B // 2, f"{what}: test rays interact")
    for a, b, name in zip(hit_k, hit_p, ("s_int", "icell", "found")):
        require(bool(torch.equal(a, b)), f"{what}: {name} identical")
    rows = nbins if bin_map is not None else n_groups
    require(rf_k.shape == rf_p.shape == (rows, tabs.rf_cells),
            f"{what}: RF rows {tuple(rf_k.shape)}")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-6 * rf_max,
            f"{what}: rf error {rf_err} <= 1e-6 * {rf_max}")
    rows_lit = int((rf_p.abs().sum(dim=1) > 0).sum())
    touched = int((rf_p != 0).sum())
    del rf_k, rf_p
    torch.cuda.empty_cache()
    g, smin, smax = lane
    dep = lum_half != 0
    n_act = active_slabs(tabs, pos[dep], dirn[dep], g[dep], smin[dep],
                         smax[dep])
    acc = torch.zeros((tabs.rf_cells, rows), dtype=torch.float64,
                      device=pos.device)
    kern = lambda: xl.sweep_deposit_prefix(*args, **kw, rf=acc)
    fresh = lambda: xl.sweep_deposit_prefix(*args, **kw)
    res = dict(max_abs_err=rf_err, rf_max=rf_max, err_of_max=rf_err / rf_max,
               n_groups=n_groups, rows=rows, rows_lit=rows_lit,
               rf_cells=tabs.rf_cells, voxels=tabs.nd.shape[0],
               cellmap=tabs.cellmap is not None, touched_entries=touched,
               crossed_pairs=n_act, ms=cuda_ms(kern),
               device_ms=device_ms(kern)["ours"],
               fresh_table_device_ms=device_ms(fresh)["all"],
               plain_ms=cuda_ms(lambda: xl.sweep_deposit_prefix_plain(
                   *args, **kw), reps=3),
               library_ms=None)
    del acc
    torch.cuda.empty_cache()
    res.update(bound(
        lane_bytes(B, 0) + 9 * B + tabs.nmax * B * 4 + n_act * 12
        + (n_act * 3 * 4 if tabs.cellmap is not None else 0) + 12 * B
        + 4 * n_groups + touched * 4 + 13 * B,
        B * (OPS_SLAB + 3 * OPS_SUB + 12) + 3 * tabs.nmax * B
        + n_act * (OPS_SLAB + 3 * (OPS_SUB + OPS_DEP))))
    return res


def phase_kernels_xl_grouped(torch) -> dict:
    """Kernel 7's grouped prefix mode on config 2's first event at 256^3
    (B = 131,072, 32 lane groups folded into the 25 RF rows by the
    launch's bin map) against its plain version (`check_grouped_xl`)."""
    from skirt9_tpu_torch.transport import sweepxl as xl
    sim = config2x256("cuda")
    require(isinstance(sim._sweep_tabs, xl.XLTables)
            and sim._sweep_tabs.n == (256,) * 3, "bench2 at 256^3 builds XL")
    rays, opts, n_groups, pre = first_event_xl(torch, sim)
    nbins = len(sim.rf_borders) - 1
    B = rays[0].shape[0]
    require(n_groups == 32 and nbins == 25 and B == B_FULL,
            f"config 2 at 256^3 runs 32 lane groups of a 2^17 batch into 25 "
            f"bins ({n_groups}, {nbins}, {B})")
    bin_map = torch.tensor(opts.rf_bin_map, dtype=torch.int32,
                           device=sim.device)
    res = check_grouped_xl(torch, "kernel 7, 32 groups at 256^3", sim, rays,
                           pre, n_groups, bin_map, nbins)
    require(res["rows_lit"] == nbins, f"kernel 7 fills the 25 bins' rows "
            f"({res['rows_lit']})")
    emit({"phase": "kernels_xl_grouped", "batch": B,
          "grid": list(sim._sweep_tabs.n),
          "sweepxl_deposit_prefix_grouped": res})
    return res


def check_prefix_xl(torch, what, tabs, rays, pre) -> dict:
    """Kernel 6's prefix mode against its plain version on one event's
    sorted lanes (first_event_xl: rays and the kernel's outputs pre): the
    record and the lane range bit for bit, the prefix and the total within
    1e-6 of each lane's tau; timed by CUDA events and the profiler, beside
    the plain version, with its bound (the rays, the voxel densities, the
    record, prefix and lane range written; the crossed slabs' DDA)."""
    from skirt9_tpu_torch.transport import sweepxl as xl
    pos, dirn, _, _, alive, sig = rays
    B = pos.shape[0]
    ev = (tabs, pos, dirn, sig, alive)
    rec_p, tb_p, tot_p, lane_p = xl.sweep_dtau_prefix_plain(*ev)
    rec_k, tb_k, tot_k, lane_k = pre
    torch.cuda.synchronize()
    require(bool((tot_p > 0).sum() > B // 2), f"{what}: the rays see matter")
    require(bool(torch.equal(rec_k, rec_p)), f"{what}: kernel 6 record")
    for a, b, name in zip(lane_k, lane_p, ("axis", "smin", "smax")):
        require(bool(torch.equal(a, b)), f"{what}: kernel 6 lane {name}")
    rel = float(((tb_k - tb_p).abs() / tot_p.clamp_min(1e-30)).max())
    rel_t = float(((tot_k - tot_p).abs() / tot_p.clamp_min(1e-30)).max())
    require(max(rel, rel_t) <= 1e-6, f"{what}: kernel 6 prefix and total "
            f"within 1e-6 of tau ({rel}, {rel_t})")
    del rec_p, tb_p
    g, smin, smax = lane_p
    n_act = active_slabs(tabs, pos, dirn, g, smin, smax)
    res = dict(max_abs_err=float((tot_k - tot_p).abs().max()),
               max_err_of_tau=max(rel, rel_t), active_pairs=n_act,
               ms=cuda_ms(lambda: xl.sweep_dtau_prefix(*ev)),
               device_ms=device_ms(lambda: xl.sweep_dtau_prefix(*ev))["ours"],
               plain_ms=cuda_ms(lambda: xl.sweep_dtau_prefix_plain(*ev),
                                reps=3), library_ms=None,
               **bound(ray_bytes(B, 1) + tabs.nd.numel() * 4
                       + 4 * tabs.nmax * B * 4 + 4 * B * 4,
                       B * OPS_LANE + n_act * (OPS_SLAB + 3 * (OPS_SUB + 2)
                                               + 4)))
    torch.cuda.empty_cache()
    return res


def phase_kernels_treexl(torch) -> dict:
    """On bench_config3ismxl's recipe at max_level 9 (a 512^3 voxel raster)
    with a one-bin RF, its first event: kernel 6's prefix mode at nmax =
    512 against its plain version (check_prefix_xl), and kernel 7's prefix
    mode with the cell map (`check_grouped_xl`)."""
    from skirt9_tpu_torch.transport import sweepxl as xl
    sim, t_tree, t_setup = config3ism("cuda", "config3ismxl9", store_rf=True)
    tabs = sim._sweep_tabs
    require(isinstance(tabs, xl.XLTables) and tabs.cellmap is not None
            and tabs.n == (512,) * 3, "the level-9 tree builds its 512^3 "
            "voxel raster")
    rays, _, _, pre = first_event_xl(torch, sim)
    k6 = check_prefix_xl(torch, "the level-9 tree at 512^3", tabs, rays, pre)
    k7 = check_grouped_xl(torch, "kernel 7 with the cell map", sim, rays,
                          pre, 1, None, 0)
    emit({"phase": "kernels_treexl", "batch": rays[0].shape[0],
          "leaves": sim.grid.ncells, "voxel_grid": list(tabs.n),
          "tree_build_s": t_tree, "setup_s": t_setup,
          "sweepxl_dtau_prefix_tree512": k6,
          "sweepxl_deposit_prefix_cellmap": k7})
    return {"sweepxl_dtau_prefix_tree512": k6,
            "sweepxl_deposit_prefix_cellmap": k7}


def phase_draw_for_draw_xl_b2(torch) -> None:
    """A reduced config 2 (80^3, an 8-bin RF in 8 lane groups, 16,384
    packets in batches of 8,192, 8 events, one self-absorption iteration)
    on the XL contracts, on the CPU (plain versions) and on the GPU
    (kernels 6-7 and detect), the same seed. Its primary segment draw for
    draw: the 8-bin RF and the SED kinds within 2e-5 of their maxima, the
    frame within 1e-3 of its brightest pixel. Then the dust emission run:
    iterations equal, L_dust within 1e-4, the RF's bins and the SED kinds
    with secondary light by their sums within 1e-3, their largest cell and
    bin differences reported. The secondary launch draws each packet's
    cell from a cdf over 512,000 cells built from the RF, whose f32 sums
    differ between the devices in their last bits, so a packet here and
    there starts in the neighbouring cell or emission bin: up to a few 1e-3
    of a cell or bin, so that the secondary light is held in sums."""
    from skirt9_tpu_torch.instruments import distant as dinst
    runs = {}
    for device in ("cpu", "cuda"):
        sim = config2(device, num_packets=16384, batch_size=8192, n=80,
                      n_rf=8, max_events=8, iterate_secondary=True,
                      max_iterations=1)
        require(type(sim._sweep_tabs).__name__ == "XLTables",
                "80^3 builds XLTables")
        prim = lambda: sim.run_primary(verbose=False)
        dust = lambda: sim.run_with_dust_emission(verbose=False)
        if device == "cuda":
            out, launches = drive(XL + DETECT, RESIDENT + ML + NOT_PATH, prim)
            out2, _ = drive(XL + DETECT, RESIDENT + ML + NOT_PATH, dust)
        else:
            out, out2 = prim(), dust()
        runs[device] = (sim, out, out2)
    (sc, (rfc, ac), (rtc, atc, ic)), (sg, (rfg, ag), (rtg, atg, ig)) = (
        runs["cpu"], runs["cuda"])
    rel = lambda g, c: float((g.double().cpu() - c.double()).abs().max()
                             / c.double().abs().max())
    rf_err = rel(rfg, rfc)
    require(rfc.shape[1] == 8 and rf_err <= 2e-5,
            f"draw-for-draw (XL config 2, primary) RF {rf_err} <= 2e-5")
    worst = 0.0
    for k in (dinst.KIND_TRANSPARENT, dinst.KIND_PRIMARY_DIRECT,
              dinst.KIND_PRIMARY_SCATTERED):
        require(float(ac[0]["sed"][k].abs().max()) > 0, f"SED kind {k} lit")
        worst = max(worst, rel(ag[0]["sed"][k], ac[0]["sed"][k]))
    require(worst <= 2e-5, f"draw-for-draw (XL config 2, primary) SEDs "
            f"{worst} <= 2e-5")
    fe = rel(ag[0]["frame"], ac[0]["frame"])
    require(fe <= 1e-3, f"draw-for-draw (XL config 2) frame {fe} <= 1e-3")
    e_l = abs(ig["L_dust"] / ic["L_dust"] - 1.0)
    require(ic["iterations"] == ig["iterations"] == 1 and e_l <= 1e-4,
            f"draw-for-draw (XL config 2) L_dust {e_l} <= 1e-4")
    sums = lambda a: a.double().cpu().sum(dim=0)
    bins_err = float(((sums(rtg) - sums(rtc)).abs() / sums(rtc)).max())
    require(bins_err <= 1e-3, f"draw-for-draw (XL config 2) RF bin sums "
            f"{bins_err} <= 1e-3")
    kinds = {}
    for k in range(atc[0]["sed"].shape[0]):
        c, g = atc[0]["sed"][k].double(), atg[0]["sed"][k].double().cpu()
        require(float(c.abs().max()) > 0, f"SED kind {k} lit")
        e_sum = abs(float(g.sum()) / float(c.sum()) - 1.0)
        kinds[dinst.KIND_NAMES[k]] = {"err_of_max": rel(g, c),
                                      "sum_rel_err": e_sum}
        require(e_sum <= 1e-3, f"draw-for-draw (XL config 2) "
                f"{dinst.KIND_NAMES[k]} SED sum {e_sum} <= 1e-3")
    emit({"phase": "draw_for_draw_xl_b2", "grid": [80] * 3, "packets": 16384,
          "batch": sc.batch_size, "rf_bins": rfc.shape[1],
          "primary_rf_err_of_max": rf_err, "primary_sed_err_of_max": worst,
          "frame_err": fe, "L_dust_rel_err": e_l,
          "rf_total_cell_err_of_max": rel(rtg, rtc),
          "rf_bin_sums_rel_err": bins_err, "sed_kinds": kinds,
          "launches": launches})


def coarse_mean(a: np.ndarray, n: int, m: int) -> np.ndarray:
    """(n^3, ...) per-cell values of an n^3 grid averaged over blocks of
    (n/m)^3 cells: the (m^3, ...) values of the m^3 grid over the same box
    (means of equal volumes)."""
    f = n // m
    tail = a.shape[1:]
    return a.reshape(m, f, m, f, m, f, *tail).mean(axis=(1, 3, 5)).reshape(
        m ** 3, *tail)


def phase_full_width_b2x256(torch, smi: str):
    """Config 2 at 256^3 (`config2x256`: bench2.ski through `load_ski` at
    2^20 packets in batches of 2^17, 24 events, the 25-bin RF and the
    40-bin emission grid), timed after a one-batch warm-up: kernels 6-7
    and detect launched, no resident or tree kernel; L_dust = L_abs_primary
    within 1e-4. Reported: packets/s as bench.py counts them, seconds and
    events per segment, the emission layer at 16.8 M cells timed apart
    (`emission_state_device`, and `prepare_device` with the luminosities'
    copy to the host), and bench2's golden ratios from the RF and the
    dust temperature averaged onto the goldens' 32^3 cells (SKIRT's, at
    32^3: a miss is listed, not required)."""
    from skirt9_tpu_torch.emission import equilibrium as eq
    from skirt9_tpu_torch.sources import secondary as sec
    from skirt9_tpu_torch.transport import sweepxl as xl
    t0 = time.perf_counter()
    sim = config2x256("cuda")
    t_setup = time.perf_counter() - t0
    require(isinstance(sim._sweep_tabs, xl.XLTables)
            and sim.grid.shape == (256,) * 3, "bench2 at 256^3 builds XL")
    n_pk = sim.num_packets
    one_batch(sim, sim.run_with_dust_emission)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (rf, accs, info), launches = drive(
        XL + DETECT, RESIDENT + ML + NOT_PATH,
        lambda: sim.run_with_dust_emission(verbose=False))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stats = dict(sim.last_stats)
    packets = n_pk * (1 + info["iterations"] + (1 if info["L_dust"] > 0 else 0))
    e_l = abs(info["L_dust"] / info["L_abs_primary"] - 1.0)
    require(info["iterations"] == 0 and e_l < 1e-4,
            f"L_dust / L_abs_primary - 1 = {e_l} (< 1e-4)")
    require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0
            and rf.shape == (256 ** 3, 25), "RF finite, non-negative, "
            "(16.8 M, 25)")
    # the emission layer between the segments, timed apart
    etabs = sim._emission_tables()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_cell, _, eps = eq.emission_state_device(
        sim.medium, etabs, rf, sim.grid.volumes(), sim.rf_scale)
    torch.cuda.synchronize()
    t_state = time.perf_counter() - t0
    t0 = time.perf_counter()
    src2 = sec.prepare_device(sim.grid, L_cell, eps,
                              np.asarray(sim.ems_borders), sim.spatial_bias,
                              bounds_dev=sim._bounds_dev)
    torch.cuda.synchronize()
    t_prepare = time.perf_counter() - t0
    del L_cell, eps, src2
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        sed_cols = np.loadtxt(sim.write_outputs(accs, "b2x256", tmp)[0])
    J = coarse_mean(mean_intensity(sim, rf), 256, 32)
    T = coarse_mean(sim.dust_temperature(rf)[:, 0], 256, 32)
    gates = bench2_gates(sed_cols, J, np.diff(np.asarray(sim.rf_borders,
                                                         np.float64)), T,
                         strict=False)
    events = sum(seg[3] for seg in stats["segments"])
    seg_s = sum(seg[2] for seg in stats["segments"])
    emit({"phase": "full_width_b2x256", "grid": list(sim.grid.shape),
          "tables": "XLTables", "packets": n_pk, "batch": sim.batch_size,
          "rf_bins": rf.shape[1], "setup_s": t_setup,
          "packets_per_s": packets / dt, "seconds": dt,
          "iterations": info["iterations"], "L_dust": info["L_dust"],
          "L_abs_primary": info["L_abs_primary"], "L_dust_rel_err": e_l,
          "segments": [{"name": n, "packets": p, "seconds": t, "events": e}
                       for n, p, t, e in stats["segments"]],
          "between_segments_s": dt - seg_s,
          "emission_state_device_s": t_state,
          "prepare_device_s": t_prepare, "events": events,
          "launches": launches, "golden_at_32_cubed": gates,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return sim, launches


def phase_rf_xl_b2x256(torch, sim) -> None:
    """The primary segment of config 2 at 256^3 on the XL contracts
    against the same seed on the resident sweep (kernels 1-2) put in place:
    RF totals within 1e-4, the largest per-cell difference reported."""
    from skirt9_tpu_torch.transport import sweep as sw
    rf, _ = sim.run_primary(verbose=False)
    tot_x = float(rf.double().sum())
    res = config2x256("cuda")
    res._sweep_tabs = sw.build_tables(res.grid, res.medium)
    (rf_r, _), launches = drive(("sweep_dtau_prefix", "sweep_deposit_prefix"),
                                XL, lambda: res.run_primary(verbose=False))
    tot_r = float(rf_r.double().sum())
    e = abs(tot_x - tot_r) / tot_r
    require(e <= 1e-4, f"XL vs resident RF total at 256^3 {e} <= 1e-4")
    cell = float((rf.double() - rf_r.double()).abs().max()
                 / rf_r.double().abs().max())
    emit({"phase": "rf_xl_b2x256", "packets": sim.num_packets,
          "rf_total_rel_err": e, "rf_cell_err_of_max": cell,
          "bins_total_rel_err": [float(v) for v in (
              (rf.double().sum(0) - rf_r.double().sum(0)).abs()
              / rf_r.double().sum(0).clamp_min(1e-300)).cpu()],
          "resident_launches": launches})


def phase_treexl_vs_ml(torch) -> dict:
    """bench_config3ismxl's level-8 tree (a 256^3 fine raster, which the
    port runs on the multi-level sweep) on its voxel raster through the
    XL contracts (the tables put in place) against the multi-level sweep,
    the same seed, with a one-bin RF: SEDs and RF totals within 1e-3, the
    per-leaf RF difference reported."""
    from skirt9_tpu_torch.transport import sweepxl as xl
    runs = {}
    for engine in ("ml", "xl"):
        sim = config3ism("cuda", "config3ismxl", store_rf=True,
                         num_packets=B_ML)[0]
        require(type(sim._sweep_tabs).__name__ == "MLTables",
                "config3ismxl builds MLTables")
        if engine == "xl":
            sim._sweep_tabs = xl.build_tree_tables(sim.grid, sim.medium)
            out, launches = drive(XL + DETECT, ML + RESIDENT + NOT_PATH,
                                  lambda: sim.run_primary(verbose=False))
        else:
            out, _ = drive(ML + DETECT, XL + RESIDENT + NOT_PATH,
                           lambda: sim.run_primary(verbose=False))
        runs[engine] = (sim, *out)
    (sm, rfm, am), (sx, rfx, ax) = runs["ml"], runs["xl"]
    sed_m, sed_x = _sed(sm, am), _sed(sx, ax)
    worst = 0.0
    for kind in ("transparent", "primarydirect", "primaryscattered",
                 "total"):
        require(sed_m[kind][0] > 0, f"{kind} SED positive")
        worst = max(worst, abs(sed_x[kind][0] - sed_m[kind][0])
                    / sed_m[kind][0])
    require(worst <= 1e-3, f"tree XL vs multi-level sweep SEDs {worst}")
    tm, tx = float(rfm.double().sum()), float(rfx.double().sum())
    e_rf = abs(tx - tm) / tm
    require(tm > 0 and e_rf <= 1e-3, f"tree XL vs multi-level RF total {e_rf}")
    res = {"phase": "treexl_vs_ml", "leaves": sm.grid.ncells,
           "fine_grid": list(sx._sweep_tabs.n), "packets": sm.num_packets,
           "sed_rel_err": worst, "rf_total_rel_err": e_rf,
           "rf_cell_err_of_max": float((rfx - rfm).abs().max()
                                       / rfm.abs().max()),
           "launches_xl": launches}
    emit(res)
    return res


# ---------------------------------------------------------------- config 5

# the reduced bench5 of the draw-for-draw checks: its meshes at 16 bins
B5_SMALL = {'numBins="32"': 'numBins="16"'}
B5_STATIC = {'velocityMagnitude="2000 km/s"': 'velocityMagnitude="0 km/s"'}
# bounds of two runs' gaps on config 5 as shares of each accumulator row's
# largest |value| (rows: sed and frame 0-2, stokes and frame_stokes 0-1;
# the other rows within 1e-5). The scattered light's azimuth comes from six
# Newton steps that do not converge for fully polarized packets scattered
# near 90 degrees, so an ulp of sin or cos moves a lane by up to pi: bounds
# about three times the port-vs-reference gaps over four seeds
# (tests/test_torch_config5.py)
B5_BOUNDS = {"sed2": 2e-4, "frame2": 2e-3, "stokes0": 2e-3, "stokes1": 2e-3,
             "frame_stokes0": 1e-2, "frame_stokes1": 1e-2}


def b5_errors(acc_a, acc_b) -> dict:
    """Gaps of two runs' accumulators, row by row as shares of acc_a's
    largest |value| (sed and frame rows 0-2, stokes and frame_stokes rows
    0-1); the Stokes V rows must be zero in both (else inf)."""
    out = {}
    for key, rows in (("sed", 3), ("frame", 3), ("stokes", 3),
                      ("frame_stokes", 3)):
        a = acc_a[key].double().cpu()
        b = acc_b[key].double().cpu()
        for j in range(rows):
            m = float(a[j].abs().max())
            if key in ("stokes", "frame_stokes") and j == 2:
                zero = m == 0.0 and float(b[j].abs().max()) == 0.0
                out[f"{key}{j}"] = 0.0 if zero else float("inf")
                continue
            require(m > 0, f"config 5 {key} row {j} lit")
            out[f"{key}{j}"] = float((a[j] - b[j]).abs().max()) / m
    return out


def config5(device, num_packets=1 << 20, batch_size=B_FULL, max_events=24,
            path=None):
    """bench.py's config 5 (bench.py:175-193): tests/golden/bench5.ski (a
    1 Lsun 5778 K point source in an edge-on electron disk, polarized
    Thomson scattering, a 2000 km/s radial outflow, 32^3, a 40-bin SED and
    a 64x64 frame with Stokes Q, U, V) through the port's `load_ski` at
    2^20 packets in batches of 2^17 and 24 events. path: another ski file
    (the reduced or static ones of `edited_ski`)."""
    from skirt9_tpu_torch.config.ski import load_ski
    return load_ski(path or os.path.join(GOLDEN, "bench5.ski"),
                    num_packets=num_packets, batch_size=batch_size,
                    max_events=max_events, device=device)


def first_event_b5(torch, sim):
    """Config 5's first scattering peel-off as the path forms it: the first
    batch launched, pass 1 and pass 2 (plain versions) to the interaction
    points, the polarized phase and Stokes values toward the instrument
    (`lifecycle.polarized_per_sr`) and the observer attenuation. Returns
    (lam, interaction positions, contributions, found, Stokes Q U V)."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.ops import stokes as stk
    from skirt9_tpu_torch.sources import base as src
    from skirt9_tpu_torch.transport import lifecycle as lc
    from skirt9_tpu_torch.transport import sweep as sw
    B, dev = sim.batch_size, sim.device
    pkt = src.launch_batch(sim.sources[0], sim._src_tabs[0], sim.grid,
                           rng.seed_key(sim.seed, dev),
                           torch.arange(B, device=dev), sim.num_packets)
    tabs = sim._sweep_tabs
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T.contiguous()
    tb, tot, lane = sw.sweep_dtau_prefix_plain(tabs, pkt.pos, pkt.dir, sig,
                                               pkt.alive)
    u = torch.tensor(np.random.default_rng(7).uniform(size=B),
                     dtype=torch.float32, device=dev)
    tau_int = -torch.log1p(-u * -torch.expm1(-tot))
    zero = torch.zeros_like(pkt.lum)
    _, s_int, _, found = sw.sweep_deposit_prefix_plain(
        tabs, pkt.pos, pkt.dir, sig, pkt.alive, zero, tau_int, tb, 1.0, lane)
    found = found & pkt.alive
    pkt = pkt._replace(pos=pkt.pos + s_int[:, None] * pkt.dir)
    tab = sim._inst_tabs[0]
    kobs = tab["kobs"]
    h = torch.zeros(B, dtype=torch.int64, device=dev)
    contrib, quv = lc.polarized_per_sr(
        pkt, sim.mueller, h, stk.s11_norm(sim.mueller)[h], pkt.lum, kobs,
        lc._detector_normals([tab])[0])
    hint = int(np.argmax(np.abs(sim.instruments[0].frame_axes()[0])
                         / np.asarray(tabs.h)))
    att = torch.exp(-sw.sweep_tau_total_plain(tabs, pkt.pos,
                                              kobs.expand(B, 3), sig, found,
                                              axis_hint=hint))
    return pkt.lam, pkt.pos, contrib * att, found, quv


def phase_kernels_b5(torch) -> dict:
    """detect's Stokes mode at config 5's first scattering peel-off (B =
    2^17, 40 bins, a 40 x 64 x 64 frame with its three Stokes cubes)
    against the plain version's terms summed exactly (check_detect): every
    accumulator, the Stokes ones included, within 1e-5 of its largest
    |value|, V identically 0; timed, with its bound (33 bytes a lane and
    the entries reached) and the plain version's time."""
    sim = config5("cuda")
    lam, ipos, contrib, found, quv = first_event_b5(torch, sim)
    require(int(found.sum()) > B_FULL // 2,
            f"config 5's first event interacts ({int(found.sum())} lanes)")
    res = check_detect(torch, sim.instruments[0], sim._inst_tabs[0], lam,
                       ipos, contrib, found, 2, quv=quv)
    require(res["stokes_v_zero"], "Stokes V identically 0")
    emit({"phase": "kernels_b5", "batch": B_FULL, **res})
    return res


def phase_draw_for_draw_b5(torch) -> dict:
    """The reduced bench5 (16^3, 16,384 packets in batches of 4,096, 8
    events) on the CPU (plain versions) and on the GPU (kernels), the same
    seed, moving and static: every accumulator row within its B5_BOUNDS
    share of its maximum (1e-5 where the light is not polarized), the total
    and Stokes frames as calibrated reported against their brightest
    pixels; kernels 1, 2 and detect launched on the GPU."""
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for variant, edits in (("moving", {}), ("static", B5_STATIC)):
            path = edited_ski("bench5", tmp, dict(B5_SMALL, **edits),
                              out=variant)
            runs = {}
            for device in ("cpu", "cuda"):
                sim = config5(device, num_packets=16384, batch_size=4096,
                              max_events=8, path=path)
                out, launches = drive(
                    RESIDENT + DETECT if device == "cuda" else (),
                    XL + ML + NOT_PATH,
                    lambda: sim.run_primary(verbose=False))
                runs[device] = (sim, out[1][0])
            (sc, ac), (sg, ag) = runs["cpu"], runs["cuda"]
            require(sc.options.kinematics == (variant == "moving"),
                    f"{variant} bench5's kinematics")
            errs = b5_errors(ac, ag)
            for k, e in errs.items():
                require(e <= B5_BOUNDS.get(k, 1e-5),
                        f"draw-for-draw (config 5, {variant}) {k} {e} <= "
                        f"{B5_BOUNDS.get(k, 1e-5)}")
            cfg = sc.instruments[0]
            from skirt9_tpu_torch.instruments import distant as dinst
            fr = {}
            for name, fn in (("total", dinst.calibrate_frame),
                             ("stokes", dinst.calibrate_stokes_frames)):
                a, b = fn(cfg, ac), fn(cfg, ag)
                fr[f"{name}_frame_err_of_brightest"] = float(
                    np.abs(a - b).max() / np.abs(a).max())
            res[variant] = {"err_of_max": errs, **fr,
                            "launches_gpu": launches}
    emit({"phase": "draw_for_draw_b5", "grid": [16] * 3, "packets": 16384,
          "batch": 4096, "events": 8, **res})
    return res


def _superpix(img, b=8):
    """tests/test_frame_parity.py's superpixels, offset by b/2."""
    h = b // 2
    img = img[..., h:, h:]
    ny, nx = img.shape[-2:]
    img = img[..., : ny // b * b, : nx // b * b]
    ny, nx = img.shape[-2:]
    return img.reshape(img.shape[:-2] + (ny // b, b, nx // b, b)).sum(
        axis=(-3, -1))


# tests/test_frame_parity.py's unit factor: /m -> /micron, /sr -> /arcsec^2
TO_REF_UNITS = 1e-6 * (np.pi / 180.0 / 3600.0) ** 2


def bench5_gates(sed_um, sed_static_um) -> dict:
    """Every gate of test_bench5_flux_parity, test_bench5_stokes_parity and
    test_bench5_kinematic_doppler_signature
    (tests/test_reference_parity.py:280-353) on a run's SED [W/m2/micron]
    (dict of kinds and Q, U, V) and the static variant's scattered SED."""
    g = np.loadtxt(os.path.join(GOLDEN, "bench5_i0_sed.dat"))
    ratios = bench5_ratios(sed_um)
    res = {}
    for kind, tol in (("transparent", 0.02), ("primarydirect", 0.02),
                      ("total", 0.02), ("primaryscattered", 0.05)):
        r = ratios[kind]
        require(abs(r - 1) < tol, f"bench5 {kind} median ratio {r} within "
                f"{tol}")
        res[f"{kind}_ratio"] = r
    q = ratios["Q"]
    require(abs(q - 1) < 0.15, f"bench5 Q median ratio {q} within 0.15")
    p_ours = np.median(sed_um["Q"] / np.maximum(sed_um["primaryscattered"],
                                                1e-300))
    p_ref = np.median(g[:, 8] / np.maximum(g[:, 4], 1e-300))
    require(abs(p_ours / p_ref - 1) < 0.15,
            f"bench5 polarization degree {p_ours} vs {p_ref} within 0.15")
    u_over_q = float(np.median(np.abs(sed_um["U"]))
                     / np.median(np.abs(sed_um["Q"])))
    require(u_over_q < 0.1, f"bench5 median |U| / median |Q| {u_over_q}")
    require(bool(np.all(sed_um["V"] == 0)), "bench5 V identically 0")
    s_mov, s_sta = sed_um["primaryscattered"], sed_static_um
    e_sum = abs(s_mov.sum() / s_sta.sum() - 1)
    shape = float(np.abs(s_mov / s_mov.sum() - s_sta / s_sta.sum()).max())
    require(e_sum <= 0.02 and shape > 5e-4,
            f"bench5 Doppler signature: sums {e_sum} within 0.02, shape "
            f"{shape} > 5e-4")
    res.update(Q_ratio=q, pol_degree_ratio=float(p_ours / p_ref),
               U_over_Q=u_over_q, doppler_sum_rel_err=e_sum,
               doppler_shape=shape)
    return res


def bench5_frame_gates(cube, cube_q, R, strict: bool = True) -> dict:
    """test_bench5_frame_and_stokes_parity's gates (tests/
    test_frame_parity.py:99-123) on the calibrated total and Stokes Q
    cubes [W/m2/micron/arcsec2] and the per-bin R: per bin at most 2% of
    the bright superpixels off by more than 6 R sqrt(F / F_sp) + 0.02 and
    the integral as pytest.approx(F, rel=max(5 R, 0.02)) holds it (whose
    default absolute tolerance, 1e-12, exceeds these integrals, ~1e-16, so
    that it always holds, in the test as here; the ratios are reported);
    the Q cube's sum within 0.15 of the golden |Q| and a 16-pixel
    superpixel correlation > 0.9. Its bounds scale with this run's R, not
    the golden run's noise, and hold at the test's own width (2^17
    packets, 12 events); at 2^20 packets strict = False reports the
    per-bin results and holds only the Q cube's gates: there the edge
    bins, where the reference's polarized peel-off records at the
    incoming wavelength (bin 0 +6.5%, bin 39 -8% against SKIRT; ROADMAP
    C), leave a superpixel of 49 outside the shrunken bound."""
    from skirt9_tpu_torch.utils.fits import read_fits
    res = {}
    gold, _ = read_fits(os.path.join(GOLDEN, "bench5_i0_total.fits"))
    gold_q, _ = read_fits(os.path.join(GOLDEN, "bench5_i0_stokesQ.fits"))
    gold = gold.reshape(cube.shape)
    worst_bad, ratios, held = 0.0, [], []
    for k in range(cube.shape[0]):
        gs, os_ = _superpix(gold[k]), _superpix(cube[k])
        F = gs.sum()
        bright = gs > 2e-3 * gs.max()
        tol = 6.0 * R[k] * np.sqrt(F / np.maximum(gs, 1e-300)) + 0.02
        bad = bright & (np.abs(os_ - gs) / np.maximum(gs, 1e-300) > tol)
        worst_bad = max(worst_bad, float(bad.mean()))
        ratios.append(float(os_.sum() / F))
        ok = bad.mean() < 0.02 and abs(os_.sum() - F) <= max(
            max(5 * R[k], 0.02) * abs(F), 1e-12)
        held.append(bool(ok))
        if strict:
            require(ok, f"bench5 frame bin {k}: {bad.sum()} bright "
                    f"superpixels off, integral ratio {ratios[-1]}")
    gq = gold_q.reshape(cube_q.shape)
    scale = float(np.abs(gq).sum())
    e_q = float(abs(cube_q.sum() - gq.sum()) / scale)
    corr = float(np.corrcoef(_superpix(cube_q[0], 16).ravel(),
                             _superpix(gq[0], 16).ravel())[0, 1])
    require(scale > 0 and e_q < 0.15 and corr > 0.9,
            f"bench5 Stokes Q frame: sum {e_q} < 0.15 of |Q|, "
            f"correlation {corr} > 0.9")
    res.update(frame_bad_superpixel_share=worst_bad,
               frame_integral_ratios=ratios, frame_bins_held=sum(held),
               frame_gates_strict=strict, q_frame_sum_err=e_q,
               q_frame_correlation=corr)
    return res


def _b5_outputs(sim, accs, tmp, prefix) -> tuple:
    """A run's written SED file as bench5_gates' dict [W/m2/micron] and its
    total and Stokes Q cubes in the goldens' units, read back from the
    FITS files, with the per-bin R."""
    sim.write_outputs(accs, prefix, tmp)
    return _b5_files(tmp, prefix, accs[0])


def _b5_files(tmp, prefix, acc) -> tuple:
    from skirt9_tpu_torch.utils.fits import read_fits
    cols = np.loadtxt(os.path.join(tmp, f"{prefix}_i0_sed.dat"))
    require(cols.shape == (40, 12) and bool(np.isfinite(cols).all()),
            f"{prefix} SED file: 40 rows, 12 finite columns")
    sed = {k: cols[:, c] for k, c in (
        ("total", 1), ("transparent", 2), ("primarydirect", 3),
        ("primaryscattered", 4), ("Q", 7), ("U", 8), ("V", 9))}
    cubes = {}
    for name in ("total", "stokesQ", "stokesU", "stokesV"):
        cube, _ = read_fits(os.path.join(tmp, f"{prefix}_i0_{name}.fits"))
        require(cube.shape == (40, 64, 64) and bool(np.isfinite(cube).all()),
                f"{prefix} {name} cube finite, 40 x 64 x 64")
        cubes[name] = cube.astype(np.float64) * TO_REF_UNITS
    require(float(np.abs(cubes["stokesV"]).max()) == 0.0,
            f"{prefix} Stokes V cube zero")
    if acc is None:
        R = cols[:, 10]           # the file's relative error column
    else:
        st = acc["stats"].double().cpu().numpy()
        R = np.sqrt(np.maximum(st[2], 0.0)) / np.maximum(st[1], 1e-300)
    return sed, cubes["total"], cubes["stokesQ"], R


def phase_full_width_b5(torch, smi: str):
    """Config 5 at bench.py's width (bench.py:175-193: bench5.ski through
    the port's load_ski, 2^20 packets in batches of 2^17, 24 events, seed
    0), a warm-up run and a timed run on the same object: kernels 1, 2 and
    detect launched, no tree or XL kernel and not kernel 3; packets/s
    beside the card's name and power limit, events; the static variant
    (velocityMagnitude 0, through edited_ski) at the same width; every gate
    of the bench5 golden tests (bench5_gates) on the written files."""
    sim = config5("cuda")
    require(type(sim._sweep_tabs).__name__ == "SweepTables"
            and sim.options.kinematics and sim.options.polarization
            and sim.options.path_length_bias == 0.0,
            "bench5: the resident sweep, kinematics, polarization, no "
            "path-length bias")
    one_batch(sim, sim.run_primary)            # warm-up
    (rf, accs), launches = drive(RESIDENT + DETECT, XL + ML + NOT_PATH,
                                 lambda: sim.run_primary(verbose=False))
    stats = dict(sim.last_stats)
    with tempfile.TemporaryDirectory() as tmp:
        sed, cube, cube_q, R = _b5_outputs(sim, accs, tmp, "b5")
        static = config5("cuda", path=edited_ski("bench5", tmp, B5_STATIC,
                                                 out="static"))
        require(not static.options.kinematics, "static bench5: no "
                "kinematics")
        _, accs0 = static.run_primary(verbose=False)
        sed0 = _b5_outputs(static, accs0, tmp, "static")[0]
        # test_bench5_frame_and_stokes_parity at its own width
        small = config5("cuda", num_packets=1 << 17, batch_size=1 << 14,
                        max_events=12)
        _, accs1 = small.run_primary(verbose=False)
        frame_test = bench5_frame_gates(
            *_b5_outputs(small, accs1, tmp, "test")[1:])
    gates = dict(bench5_gates(sed, sed0["primaryscattered"]),
                 frame_test_width=frame_test,
                 frame_full_width=bench5_frame_gates(cube, cube_q, R,
                                                     strict=False))
    res = {"phase": "full_width_b5", "grid": list(sim.grid.shape),
           "packets": sim.num_packets, "batch": sim.batch_size,
           "packets_per_s": sim.last_rate, "seconds": stats["seconds"],
           "events": stats["events"], "syncs": stats["syncs"],
           "static_packets_per_s": static.last_rate,
           "static_events": static.last_stats["events"],
           "launches": launches,
           "kernel_launches_per_event": sum(launches.values())
           / stats["events"], **gates,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit(res)
    uniform = {"packets_per_s": sim.last_rate,
               "golden_ratios": bench5_ratios(sed),
               "transparent_sed": sed["transparent"]}
    return sim, launches, uniform


def phase_breakdown_b5(torch, sim) -> None:
    """Config 5 with one batch of 2^17 packets under torch.profiler
    (host_per_event, on full_width_b5's simulation, which has run): device
    operations, stream syncs and host copies per event of the loop, busy
    and idle shares, the kernels that take the most device time."""
    sim.num_packets = B_FULL
    prof = host_per_event(
        torch, sim, lambda s: s.run_primary(verbose=False), warm=True)
    emit({"phase": "breakdown_b5", "packets": B_FULL, **prof})


# ------------------------------------------------------------ configs 6, 7

B_B67 = 1 << 16           # bench_config6's and bench_config7's batch
# bounds of the CPU-vs-GPU gaps of the reduced configs 6 and 7
# (draw_for_draw_b6/_b7), as shares of each SED row's maximum, stated
# before their first run on the card. The transparent and direct light
# take no discrete decision after launch: 1e-5. The Lya scattered light:
# PyTorch's tan and atan on the card and on the CPU differ by ulps, which
# flip a rejection test about once per 10^5 draws and move that lane for
# the rest of its life, as between the port and the reference on the CPU
# (tests/test_torch_config67.py: 0.13-0.21% of the detections, 3.5e-3 of
# the scattered SED's maximum, 1.2e-3 of its sum): the same bounds as
# there. The X-ray scattered light: its channel shares and line draws run
# in XLA's arithmetic on both devices (ops/xlamath.py) and its angles and
# interpolated cross sections differ only continuously: 1e-3 of the
# maximum and of the sum, room for one flipped lane
B6_BOUNDS = {"exact": 1e-5, "scattered_of_max": 1.5e-2, "scattered_sum": 5e-3}
B7_BOUNDS = {"exact": 1e-5, "scattered_of_max": 1e-3, "scattered_sum": 1e-3}
B67_SMALL = {"bench6": dict(num_packets=4096, batch_size=4096, max_events=12),
             "bench7": dict(num_packets=4096, batch_size=4096, max_events=16)}


def config6(device, num_packets=1 << 17, batch_size=B_B67, max_events=128):
    """bench.py's config 6 (bench.py:196-212): tests/golden/bench6.ski
    (Lyman-alpha line transfer: a 100 km/s Gaussian line source in a uniform
    neutral-hydrogen sphere at 10^4 K, line-centre optical depth 10^5 from
    the centre, Constant core skipping, 32^3, a 75-bin SED) through the
    port's `load_ski` at 2^17 packets in batches of 2^16 and 128 events."""
    from skirt9_tpu_torch.config.ski import load_ski
    return load_ski(os.path.join(GOLDEN, "bench6.ski"),
                    num_packets=num_packets, batch_size=batch_size,
                    max_events=max_events, device=device)


def config7(device, num_packets=1 << 18, batch_size=B_B67, max_events=16):
    """bench.py's config 7 (bench.py:215-231): tests/golden/bench7.ski
    (X-ray atomic gas: a flat 0.3-10 keV source in a uniform sphere of
    hydrogen column 2 x 10^23 cm^-2 with the golden XRay_PA/FL data, Compton
    scattering on free electrons and Fe K fluorescence, 32^3, a 60-bin SED)
    through the port's `load_ski` at 2^18 packets in batches of 2^16 and 16
    events."""
    from skirt9_tpu_torch.config.ski import load_ski
    return load_ski(os.path.join(GOLDEN, "bench7.ski"),
                    num_packets=num_packets, batch_size=batch_size,
                    max_events=max_events, device=device)


def sed_gaps(acc_a, acc_b) -> dict:
    """Gaps of two runs' SED rows (transparent, direct, scattered) as shares
    of acc_a's row maxima, and of the scattered row's sum."""
    a = acc_a["sed"].double().cpu()
    b = acc_b["sed"].double().cpu()
    out = {}
    for k, name in enumerate(("transparent", "primarydirect",
                              "primaryscattered")):
        m = float(a[k].abs().max())
        require(m > 0, f"SED row {name} lit")
        out[name] = float((a[k] - b[k]).abs().max()) / m
    out["scattered_sum"] = abs(float(b[2].sum() / a[2].sum()) - 1.0)
    return out


def hold_gaps(name, gaps, bounds) -> None:
    for key, e in gaps.items():
        bound = (bounds["scattered_sum"] if key == "scattered_sum" else
                 bounds["scattered_of_max"] if key == "primaryscattered"
                 else bounds["exact"])
        require(e <= bound, f"draw-for-draw ({name}) {key} {e} <= {bound}")


# test_bench6_lya_profile_parity's own run (tests/test_reference_parity.py:
# 466-474): 20,000 packets in the loader's batches of 16,384, 128 events
B6_TEST = dict(num_packets=20_000, batch_size=16_384, max_events=128)


def bench6_gates(lam_um, total, direct, strict_peak: bool = True) -> dict:
    """Every gate of test_bench6_lya_profile_parity (tests/
    test_reference_parity.py:477-506) on a run's SED [micron, W/m2/micron]
    against tests/golden/bench6_i0_sed.dat: a dark core on both sides, the
    peaks at the same bins (one bin), the escaped energy within 5%, the
    profile within a median 2% and at most 15% of the golden maximum over
    its live range, and the direct light at line centre below 1e-6 of the
    maximum. The golden's blue and red peaks (bins 30 and 44) differ by
    0.5%, so which of the two is the highest is the noise of a run: with
    strict_peak False the highest peak's bin is reported, not held (the
    blue peak's bin still is); the test's own run (B6_TEST) holds it."""
    golden = np.loadtxt(os.path.join(GOLDEN, "bench6_i0_sed.dat"))
    ref = golden[:, 1]
    require(lam_um.shape == ref.shape, f"bench6 SED bins {lam_um.shape}")
    i0 = int(np.argmin(np.abs(lam_um - 0.1215670)))
    res = {"core_of_max": float(total[i0] / total.max()),
           "peak_bin": int(np.argmax(total)),
           "golden_peak_bin": int(np.argmax(ref)),
           "blue_peak_bin": int(np.argmax(total[:i0])),
           "golden_blue_peak_bin": int(np.argmax(ref[:i0])),
           "integral_ratio": float(np.trapezoid(total, lam_um)
                                   / np.trapezoid(ref, lam_um)),
           "direct_core_of_max": float(direct[i0] / total.max())}
    m = ref > 1e-2 * ref.max()
    rel = np.abs(total[m] - ref[m]) / ref.max()
    res.update(profile_median=float(np.median(rel)),
               profile_max=float(rel.max()))
    require(res["core_of_max"] < 1e-4 and ref[i0] < 1e-4 * ref.max(),
            f"bench6 dark core ({res['core_of_max']})")
    require(abs(res["blue_peak_bin"] - res["golden_blue_peak_bin"]) <= 1
            and (abs(res["peak_bin"] - res["golden_peak_bin"]) <= 1
                 or not strict_peak),
            f"bench6 peaks at the golden bins: {res}")
    res["peak_held"] = abs(res["peak_bin"] - res["golden_peak_bin"]) <= 1
    ratio = lambda a: float(a[:i0].max() / a[i0:].max())
    res.update(blue_over_red=ratio(total), golden_blue_over_red=ratio(ref))
    require(abs(res["integral_ratio"] - 1.0) < 0.05,
            f"bench6 escaped energy {res['integral_ratio']} within 5%")
    require(res["profile_median"] < 0.02 and res["profile_max"] < 0.15,
            f"bench6 profile median {res['profile_median']} < 0.02, max "
            f"{res['profile_max']} < 0.15")
    require(res["direct_core_of_max"] < 1e-6,
            f"bench6 direct light at line centre {res['direct_core_of_max']}")
    return res


def bench7_gates(lam_um, transp, direct, scat) -> dict:
    """Every gate of test_bench7_xray_parity (tests/test_reference_parity.py:
    528-566) on a run's SED [micron, W/m2/micron] against tests/golden/
    bench7_i0_sed.dat, whose scattered light is its primary scattered plus
    both secondary columns (the reference tags fluorescence as secondary):
    the transparent and direct medians within 2% and 5%, the optical depth
    at 1 keV within 5%, the scattered integral within 10%, the Fe K-alpha
    bin 1.5 times its continuum on both sides and its excess within 30%."""
    g = np.loadtxt(os.path.join(GOLDEN, "bench7_i0_sed.dat"))
    lam = g[:, 0]
    require(lam_um.shape == lam.shape
            and np.allclose(lam_um, lam, rtol=1e-6),
            "bench7 SED wavelengths are the golden's")
    r_transp, r_direct = g[:, 2], g[:, 3]
    r_scat = g[:, 4] + g[:, 5] + g[:, 6]
    res = {}
    hi = r_transp > 0.05 * r_transp.max()
    res["transparent_median_ratio"] = float(np.median(transp[hi]
                                                      / r_transp[hi]))
    hi = r_direct > 0.05 * r_direct.max()
    res["direct_median_ratio"] = float(np.median(direct[hi] / r_direct[hi]))
    E = 1.23984193e-3 / lam
    i1 = int(np.argmin(np.abs(E - 1.0)))
    tau_o = -math.log(direct[i1] / transp[i1])
    tau_r = -math.log(r_direct[i1] / r_transp[i1])
    res["tau_1keV"], res["golden_tau_1keV"] = tau_o, tau_r
    res["scattered_integral_ratio"] = float(np.trapezoid(scat, lam)
                                            / np.trapezoid(r_scat, lam))
    ika = int(np.argmin(np.abs(E - 6.4)))
    cont_o = 0.5 * (scat[ika - 2] + scat[ika + 2])
    cont_r = 0.5 * (r_scat[ika - 2] + r_scat[ika + 2])
    res["fe_ka_over_continuum"] = float(scat[ika] / cont_o)
    res["golden_fe_ka_over_continuum"] = float(r_scat[ika] / cont_r)
    res["fe_ka_excess_ratio"] = float((scat[ika] - cont_o)
                                      / (r_scat[ika] - cont_r))
    require(abs(res["transparent_median_ratio"] - 1) < 0.02
            and abs(res["direct_median_ratio"] - 1) < 0.05,
            f"bench7 transparent and direct medians: {res}")
    require(abs(tau_o / tau_r - 1) < 0.05,
            f"bench7 tau at 1 keV {tau_o} vs {tau_r} within 5%")
    require(abs(res["scattered_integral_ratio"] - 1) < 0.10,
            f"bench7 scattered integral {res['scattered_integral_ratio']}")
    require(res["fe_ka_over_continuum"] > 1.5
            and res["golden_fe_ka_over_continuum"] > 1.5
            and abs(res["fe_ka_excess_ratio"] - 1) < 0.30,
            f"bench7 Fe K-alpha line: {res}")
    return res


def b67_file_gates(name, path, strict_peak: bool = True) -> dict:
    """A written SED file of config 6 or 7 (the reference's columns:
    wavelength, total, transparent, direct, scattered, the secondary kinds,
    R, VOV) through its golden gates."""
    cols = np.loadtxt(path)
    nb = 75 if name == "bench6" else 60
    require(cols.shape == (nb, 9) and bool(np.isfinite(cols).all()),
            f"{name} SED file: {nb} rows, 9 finite columns")
    if name == "bench6":
        return bench6_gates(cols[:, 0], cols[:, 1], cols[:, 3], strict_peak)
    return bench7_gates(cols[:, 0], cols[:, 2], cols[:, 3], cols[:, 4])


def first_event_b6(torch, sim):
    """Config 6's first scattering event as the path forms it, in the plain
    versions: the first batch launched, its Lya cross sections at the
    uniform gas temperature, pass 1 (prefix and lane range), the forced
    interaction depth from the event's own uniform, pass 2 to the
    interaction points, the Lya scattering (`lifecycle.lya_event`) and the
    peel-off toward the instrument at the redistributed wavelengths (its
    cross sections and contributions). Returns a dict of these tensors."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.ops import lya as lyo
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.sources import base as src
    from skirt9_tpu_torch.transport import lifecycle as lc
    from skirt9_tpu_torch.transport import sweep as sw
    B, dev, med = sim.batch_size, sim.device, sim.medium
    pkt = src.launch_batch(sim.sources[0], sim._src_tabs[0], sim.grid,
                           rng.seed_key(sim.seed, dev),
                           torch.arange(B, device=dev), sim.num_packets)
    T0 = lc.check_wavelength_changing(med, sim.options, 0)
    sig_of = lambda lam: (msys.optics_at(med, lam).sigma_ext.T
                          + lyo.cross_section(lam, T0)).contiguous()
    sig = sig_of(pkt.lam)
    tabs = sim._sweep_tabs
    tb, tot, lane = sw.sweep_dtau_prefix_plain(tabs, pkt.pos, pkt.dir, sig,
                                               pkt.alive)
    keys = rng.event_keys(pkt.hkey, pkt.nscat)
    tags = (lc._TAG_PATH_TAU_EXP, lc._TAG_SCATTER_CT, lc._TAG_SCATTER_PHI,
            lc._TAG_LYA_DIPOLE, lc._TAG_LYA_SKIP_R, lc._TAG_LYA_SKIP_A)
    u = dict(zip(tags, rng.uniforms(keys, tags)))
    tau_int = rng.expon_cutoff_from_uniform(u[lc._TAG_PATH_TAU_EXP], tot)
    zero = torch.zeros_like(pkt.lum)
    _, s_int, icell, found = sw.sweep_deposit_prefix_plain(
        tabs, pkt.pos, pkt.dir, sig, pkt.alive, zero, tau_int, tb, 1.0,
        lane)
    found = found & pkt.alive & (tot > 1e-6)
    at = pkt._replace(pos=pkt.pos + s_int[:, None] * pkt.dir)
    _, _, per_sr, lam_fn = lc.lya_event(med, sim.options, keys, u, at, icell,
                                        at.lam)
    kobs = sim._inst_tabs[0]["kobs"]
    lam_det = lam_fn(kobs)
    return {"pkt": pkt, "sig": sig, "tb": tb, "tot": tot, "lane": lane,
            "tau_int": tau_int, "s_int": s_int, "icell": icell,
            "found": found, "ipos": at.pos, "kobs": kobs.expand(B, 3),
            "sig_det": sig_of(lam_det), "lam_det": lam_det,
            "contrib": per_sr(0, kobs)[0],
            "hint": int(np.argmax(np.abs(sim.instruments[0].frame_axes()[0])
                                  / np.asarray(tabs.h)))}


def check_kernels_b6(torch, sim, timed: bool = True) -> dict:
    """Kernels 1, 2 and detect at config 6's first scattering event (line-
    centre optical depths up to 10^5 along a path, in the kernels' f32
    prefix and interaction search; cross sections per lane; detection
    wavelengths per lane, some outside the 75-bin grid) against their plain
    versions on the same CUDA tensors: kernel 1's prefix mode (pass 1) with
    its lane range bit for bit and the prefix within 1e-6 of each lane's
    tau; its total mode (the peel-off toward the instrument at the
    redistributed wavelengths) within 1e-6 of each lane's tau; kernel 2's
    prefix mode without an RF (pass 2) with found and icell identical and
    s_int within 1e-5 of a cell; detect as check_detect holds it. With
    timed, each is timed (CUDA events, device time) beside its bound and
    the plain version's time."""
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.kernels import build as kb
    from skirt9_tpu_torch.transport import sweep as sw
    ev = first_event_b6(torch, sim)
    tabs, pkt = sim._sweep_tabs, ev["pkt"]
    B, h = pkt.lam.shape[0], float(min(tabs.h))
    out = {}
    pass1 = (tabs, pkt.pos, pkt.dir, ev["sig"], pkt.alive)
    peel = (tabs, ev["ipos"], ev["kobs"], ev["sig_det"], ev["found"],
            ev["hint"])
    tb_k, tot_k, lane_k = sw.sweep_dtau_prefix(*pass1)
    t_k = sw.sweep_tau_total(*peel)
    t_p = sw.sweep_tau_total_plain(*peel)
    torch.cuda.synchronize()
    for a, b, name in zip(lane_k, ev["lane"], ("axis", "smin", "smax")):
        require(bool(torch.equal(a, b)),
                f"kernel 1 lane {name} bit-identical at Lya depths")
    scale = ev["tot"].clamp_min(1e-30)
    rel_pre = max(float(((tot_k - ev["tot"]).abs() / scale).max()),
                  float(((tb_k - ev["tb"]).abs() / scale[None, :]).max()))
    rel_tot = float(((t_k - t_p).abs() / t_p.clamp_min(1e-30)).max())
    require(float(ev["tot"].max()) > 1e4,
            f"config 6 paths reach Lya depths ({float(ev['tot'].max())})")
    require(rel_pre <= 1e-6, f"kernel 1 prefix at Lya depths within 1e-6 "
            f"of each lane's tau ({rel_pre})")
    require(rel_tot <= 1e-6, f"kernel 1 total at Lya depths within 1e-6 "
            f"of each lane's tau ({rel_tot})")
    out["sweep_dtau_prefix"] = dict(max_err_of_tau=rel_pre,
                                    max_abs_err=rel_pre * float(scale.max()),
                                    max_tau=float(ev["tot"].max()))
    out["sweep_tau_total"] = dict(max_err_of_tau=rel_tot,
                                  max_abs_err=rel_tot * float(t_p.max()),
                                  max_tau=float(t_p.max()))
    # kernel 2's prefix mode without an RF, on pass 1's prefix and range
    zero = torch.zeros_like(pkt.lum)
    dep = (tabs, pkt.pos, pkt.dir, ev["sig"], pkt.alive, zero, ev["tau_int"],
           ev["tb"], 1.0, ev["lane"])
    _, s_k, c_k, f_k = sw.sweep_deposit_prefix(*dep)
    _, s_p, c_p, f_p = sw.sweep_deposit_prefix_plain(*dep)
    torch.cuda.synchronize()
    require(int(f_p.sum()) > B // 2, "config 6's first event interacts")
    require(bool(torch.equal(f_k, f_p)) and bool(torch.equal(c_k, c_p)),
            "kernel 2 at Lya depths: found and icell identical")
    ds = float((s_k - s_p)[f_p].abs().max())
    require(ds <= 1e-5 * h, f"kernel 2 s_int {ds} within 1e-5 of a cell")
    out["sweep_deposit_prefix"] = dict(max_abs_err=ds,
                                       found_lanes=int(f_p.sum()))
    # detect on the 75 bins at the redistributed wavelengths
    borders = sim._inst_tabs[0]["wave_borders"]
    lam = ev["lam_det"]
    outside = ev["found"] & ((lam < borders[0]) | (lam >= borders[-1]))
    require(int(outside.sum()) > 0 and int((ev["found"] & ~outside).sum())
            > B // 4, "detection wavelengths inside and outside the grid")
    if not timed:
        cfg, tab = sim.instruments[0], sim._inst_tabs[0]
        args = (lam, ev["ipos"], ev["contrib"], 2, ev["found"])
        kb.reset_launches()
        acc_k = dinst.detect(cfg, tab, dinst.init_accumulators(cfg, sim.device),
                             *args)
        require(kb.LAUNCHES["detect"] == 1, "detect: one kernel launch")
        acc_p = dinst.detect_plain(cfg, tab,
                                   dinst.init_accumulators(cfg, sim.device),
                                   *args, scatter=scatter_f64)
        for key in acc_p:
            m = float(acc_p[key].abs().max())
            require(m > 0 and float((acc_k[key] - acc_p[key]).abs().max())
                    <= 1e-5 * m, f"detect at config 6's shapes: {key}")
        out["detect"] = {"lanes_outside_grid": int(outside.sum())}
        return out
    out["detect"] = check_detect(torch, sim.instruments[0],
                                 sim._inst_tabs[0], lam, ev["ipos"],
                                 ev["contrib"], ev["found"], 2)
    out["detect"]["lanes_outside_grid"] = int(outside.sum())
    g, smin, smax, _ = sw._prep(*pass1)
    n_act = active_slabs(tabs, pkt.pos, pkt.dir, g, smin, smax)
    gp, smin_p, smax_p, _ = sw._prep(*peel[:5])
    n_peel = active_slabs(tabs, ev["ipos"], ev["kobs"], gp, smin_p, smax_p)
    tab_bytes = tabs.nd.numel() * 4
    for name, fn, plain, args, pairs, out_bytes in (
            ("sweep_dtau_prefix", sw.sweep_dtau_prefix,
             sw.sweep_dtau_prefix_plain, pass1, n_act,
             tabs.nmax * B * 4 + 4 * B * 4),
            ("sweep_tau_total", sw.sweep_tau_total, sw.sweep_tau_total_plain,
             peel, n_peel, B * 4),
            ("sweep_deposit_prefix", sw.sweep_deposit_prefix,
             sw.sweep_deposit_prefix_plain, dep, n_act, 0)):
        dev_t = device_ms(lambda: fn(*args))
        # device_launches below 1 a call: the profiler dropped events
        out[name].update(
            active_pairs=pairs, ms=cuda_ms(lambda: fn(*args)),
            plain_ms=cuda_ms(lambda: plain(*args), reps=5), library_ms=None,
            device_ms=dev_t["ours"], device_launches=dev_t["launches"])
        if name == "sweep_deposit_prefix":
            out[name].update(deposit_bound(name, tabs, B, pairs, 0))
        else:
            out[name].update(bound(
                ray_bytes(B, 1) + tab_bytes + out_bytes,
                B * OPS_LANE + pairs * (OPS_SLAB + 3 * (OPS_SUB + 2)
                                        + (2 if name == "sweep_dtau_prefix"
                                           else 1))))
    return out


def phase_kernels_b6(torch) -> dict:
    """check_kernels_b6 on config 6's first batch (B = 2^16), timed."""
    sim = config6("cuda")
    out = check_kernels_b6(torch, sim)
    emit({"phase": "kernels_b6", "batch": sim.batch_size,
          "grid": list(sim._sweep_tabs.n), **out})
    return out


def phase_draw_for_draw_b67(torch, name) -> dict:
    """The reduced config 6 or 7 (B67_SMALL: 4,096 packets, 12 or 16
    events) on the CPU (plain versions) and on the GPU (kernels), the same
    seed: each SED row within its B6_BOUNDS or B7_BOUNDS share of its
    maximum; kernels 1, 2 and detect launched on the GPU and no other
    sweep."""
    config, bounds = ((config6, B6_BOUNDS) if name == "bench6"
                      else (config7, B7_BOUNDS))
    runs, launches = {}, None
    for device in ("cpu", "cuda"):
        sim = config(device, **B67_SMALL[name])
        out, l_ = drive(RESIDENT + DETECT if device == "cuda" else (),
                        XL + ML + NOT_PATH,
                        lambda: sim.run_primary(verbose=False))
        runs[device] = out[1][0]
        if device == "cuda":
            launches = l_
    gaps = sed_gaps(runs["cpu"], runs["cuda"])
    hold_gaps(name, gaps, bounds)
    phase = "draw_for_draw_b6" if name == "bench6" else "draw_for_draw_b7"
    emit({"phase": phase, **B67_SMALL[name], "gaps_of_max": gaps,
          "bounds": bounds, "launches_gpu": launches})
    return gaps


def phase_full_width_b67(torch, smi: str, name):
    """Config 6 or 7 at bench.py's width (bench_config6: 2^17 packets, 128
    events; bench_config7: 2^18 packets, 16 events; batches of 2^16, seed
    0): a one-batch warm-up, then the timed run on the same object, driven
    with the launch counts set to 0: kernels 1, 2 and detect launched, no
    tree or XL kernel and not kernel 3; packets/s beside the card's name
    and power limit, events; every gate of the golden test on the SED file
    the run writes (bench6_gates, bench7_gates); for bench6 the highest
    peak's bin at this width is reported (its golden peaks differ by 0.5%)
    and every gate is held at the test's own width (B6_TEST)."""
    config = config6 if name == "bench6" else config7
    sim = config("cuda")
    require(type(sim._sweep_tabs).__name__ == "SweepTables"
            and (sim.options.lya if name == "bench6" else sim.options.xray),
            f"{name}: the resident sweep, its physics on")
    n_pk = sim.num_packets
    one_batch(sim, sim.run_primary)            # warm-up
    (rf, accs), launches = drive(RESIDENT + DETECT, XL + ML + NOT_PATH,
                                 lambda: sim.run_primary(verbose=False))
    stats = dict(sim.last_stats)
    sed_file = lambda s_, a_, tmp: [p for p in s_.write_outputs(a_, name, tmp)
                                    if p.endswith("_sed.dat")][0]
    with tempfile.TemporaryDirectory() as tmp:
        gates = b67_file_gates(name, sed_file(sim, accs, tmp),
                               strict_peak=False)
        if name == "bench6":
            # every gate, the highest peak's bin too, at the test's width
            test = config6("cuda", **B6_TEST)
            _, accs_t = test.run_primary(verbose=False)
            gates = {"full_width": gates, "test_width": b67_file_gates(
                name, sed_file(test, accs_t, tmp))}
    res = {"phase": f"full_width_{'b6' if name == 'bench6' else 'b7'}",
           "grid": list(sim.grid.shape), "packets": n_pk,
           "batch": sim.batch_size, "max_events": sim.options.max_events,
           "packets_per_s": sim.last_rate, "seconds": stats["seconds"],
           "events": stats["events"], "syncs": stats["syncs"],
           "launches": launches,
           "kernel_launches_per_event": sum(launches.values())
           / stats["events"], "gates": gates,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit(res)
    return launches


def phase_breakdown_b6(torch) -> None:
    """One batch of config 6 (2^15 packets, its first 8 events: every Lya
    event issues the same operations) under torch.profiler
    (host_per_event): device operations, stream syncs and host copies per
    event of the Lya loop, busy and idle shares, the kernels that take the
    most device time."""
    prof = host_per_event(torch, config6("cuda", num_packets=B_B67 // 2,
                                         max_events=8),
                          lambda s: s.run_primary(verbose=False))
    emit({"phase": "breakdown_b6", "packets": B_B67 // 2, "max_events": 8,
          **prof})


# ------------------------------------------------------------- config 4

B_B4 = 1 << 16            # bench_config4's batch (bench.py:152-172)
N_B4 = 1 << 19            # and its packets
# the reduced bench4 of draw_for_draw_b4 (tests/test_torch_config4.py's run)
B4_SMALL = dict(num_packets=8192, batch_size=4096, max_events=4)
# test_reference_parity.py's own bench4 run (_run_bench4: 10^5 packets in
# batches of 8,192, 16 events)
B4_TEST = dict(num_packets=100_000, batch_size=8192, max_events=16)
# CPU against GPU on config 4: the primary light (SED kinds 0-2, the RF)
# draw for draw within `primary` of each maximum; the secondary light by
# its sums within `secondary_sum`: the secondary launch draws each packet's
# cell from a cdf over the 2,895 cells built from the RF's f32 sums, which
# differ between the devices in their last bits, so a packet here and there
# starts in another cell (ROADMAP queue C); the frame within 1e-3 of its
# brightest pixel
B4_BOUNDS = {"primary": 2e-5, "secondary_sum": 1e-3, "frame": 1e-3}
L_SUN_B4 = 3.846e26       # test_bench4_source_luminosity's solar luminosity


def config4(device, num_packets=N_B4, batch_size=B_B4, max_events=24,
            path=None):
    """bench.py's config 4 (bench.py:152-172): tests/golden/bench4.ski
    through the port's `load_ski` (40 star particles with a FileSSPSEDFamily,
    a 2,895-site Voronoi medium of MRN dust rasterized onto 73^3 voxels for
    kernels 4-5, a 25-bin RF in 32 lane groups, a 40-bin emission grid, a
    40-bin SED and 64x64 frame). path: another ski file (a reduced copy)."""
    from skirt9_tpu_torch.config.ski import load_ski
    return load_ski(path or os.path.join(GOLDEN, "bench4.ski"),
                    num_packets=num_packets, batch_size=batch_size,
                    max_events=max_events, device=device)


def _kernel4_b4(torch, sim, pkt, sig, where: str = "73^3 raster") -> dict:
    """Kernel 4's prefix mode on the event rays and its total mode on the
    peel-off toward the instrument, against their plain versions: the lane
    range and the leaf ids identical, the record, step sums, prefix and
    totals within 1e-6 of each lane's tau; timed, with their bounds.
    where names the configuration in the failure messages."""
    from skirt9_tpu_torch.transport import mlsweep as ml
    from skirt9_tpu_torch.transport import sweep as sw
    tabs = sim._sweep_tabs
    B = pkt.lam.shape[0]
    ev = (tabs, pkt.pos, pkt.dir, sig, pkt.alive)
    kobs = sim._inst_tabs[0]["kobs"].expand(B, 3).contiguous()
    hint = int(np.argmax(np.abs(sim._inst_tabs[0]["kobs"].cpu().numpy())
                         / np.asarray(tabs.h)))
    pl = (tabs, pkt.pos, kobs, sig, pkt.alive, hint)
    pre_k = ml.sweep_dtau_prefix(*ev)
    pre_p = ml.sweep_dtau_prefix_plain(*ev)
    tot_k, tot_p = ml.sweep_tau_total(*pl), ml.sweep_tau_total_plain(*pl)
    torch.cuda.synchronize()
    tau = pre_p[4]
    require(int((tau > 0).sum()) > B // 2 and int((tot_p > 0).sum()) > B // 2,
            f"the rays and peel-offs see dust ({where})")
    of_tau = lambda a, b, t: float(((a - b).abs()
                                    / t.clamp_min(1e-30)).max())
    errs = {"record": of_tau(pre_k[0], pre_p[0], tau[None, None, :]),
            "step_sums": of_tau(pre_k[2], pre_p[2], tau[None, :]),
            "prefix": of_tau(pre_k[3], pre_p[3], tau[None, :]),
            "total": of_tau(pre_k[4], tau, tau),
            "peel_off_total": of_tau(tot_k, tot_p, tot_p)}
    for what, e in errs.items():
        require(e <= 1e-6, f"kernel 4 {what} within 1e-6 of each lane's tau "
                f"({where}): {e}")
    require(bool(torch.equal(pre_k[1], pre_p[1])),
            f"kernel 4 leaf ids identical ({where})")
    for a, b, name in zip(pre_k[5], pre_p[5], ("axis", "smin", "smax")):
        require(bool(torch.equal(a, b)), f"kernel 4 lane range's {name} "
                f"identical ({where})")
    # the record and its step sums (the prefix and totals add in another
    # order)
    identical = all(bool(torch.equal(a, b)) for a, b in (
        (pre_k[0], pre_p[0]), (pre_k[2], pre_p[2])))
    g, smin, smax = pre_p[5]
    n_live = int(ml._plan_substeps(tabs, pkt.pos, pkt.dir, g, smin,
                                   smax)[3].sum())
    gz, sminz, smaxz = sw._lane_range(tabs, pkt.pos, kobs, pkt.alive)
    n_live_z = int(ml._plan_substeps(tabs, pkt.pos, kobs,
                                     torch.full_like(gz, hint), sminz,
                                     smaxz)[3].sum())
    del pre_k, pre_p
    NS = tabs.n_steps
    rec = NS * 3 * B * 4
    base = (ray_bytes(B, 1) + tabs.nd.numel() * 4 + tabs.leafmap.numel() * 4
            + 2 * NS * 4)
    march = lambda n: B * OPS_LANE + n * (OPS_SLAB + 3 * (OPS_SUB + 2 + 1))
    out = {}
    for name, fn, plain, out_b, ops, live, e in (
            ("mlsweep_dtau_prefix", lambda: ml.sweep_dtau_prefix(*ev),
             lambda: ml.sweep_dtau_prefix_plain(*ev),
             2 * rec + 2 * NS * B * 4 + 4 * B * 4,
             march(n_live) + 2 * NS * B, n_live,
             max(errs["record"], errs["prefix"], errs["total"])),
            ("mlsweep_tau_total", lambda: ml.sweep_tau_total(*pl),
             lambda: ml.sweep_tau_total_plain(*pl), B * 4, march(n_live_z),
             n_live_z, errs["peel_off_total"])):
        out[name] = dict(
            max_abs_err=e, max_err_of_tau=e,
            record_bit_identical=identical,
            ms=cuda_ms(fn), device_ms=device_ms(fn)["ours"],
            plain_ms=cuda_ms(plain, reps=3), library_ms=None,
            live_pairs=live, live_share=live / (NS * B),
            fine_grid=list(tabs.n),
            n_steps=NS, leaves=tabs.nd.shape[0], **bound(base + out_b, ops))
        torch.cuda.empty_cache()
    return out


def phase_kernels_b4(torch) -> dict:
    """Kernels 4-5 and detect at config 4's first event: the first
    stratified batch of the star particles (2^16 lanes, 32 lane groups)
    on the 73^3 raster of the 2,895 Voronoi cells, a 73-step plan of one
    fine slab each (73 is no multiple of kernel 4's 16-step runs). Kernel
    4's prefix and total modes (_kernel4_b4); kernel 5's grouped mode into
    the 25 RF rows (the global path: 2,895 leaves, 32 groups) against its
    plain version, RF within 1e-6 of its maximum, s_int, icell and found
    identical; detect on the first scattering peel-off (40 bins, 40x64x64
    frame) against the plain version's terms summed exactly. Timed, with
    bounds."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.transport import mlsweep as ml
    sim = config4("cuda")
    tabs = sim._sweep_tabs
    require(tabs.n == (73, 73, 73) and tabs.n_steps == 73
            and tabs.n_steps % ml.RUN != 0,
            f"bench4 rasterizes onto 73^3 with a 73-step plan ({tabs.n}, "
            f"{tabs.n_steps})")
    pkt, opts, (rec, cells, _, tb, tot, lane) = first_event_b3(torch, sim)
    B, n_groups = pkt.lam.shape[0], opts.rf_strata
    nbins = len(sim.rf_borders) - 1
    require(n_groups == 32 and B == B_B4 and nbins == 25,
            f"config 4 runs 32 lane groups of a 2^16 batch into 25 bins "
            f"({n_groups}, {B}, {nbins})")
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T.contiguous()
    out = _kernel4_b4(torch, sim, pkt, sig)
    ncells = tabs.nd.shape[0]
    rs = np.random.default_rng(9)
    inv_sqrt = 1.0 / math.sqrt(sim.rf_scale)
    rfb = sim._rf_borders_dev
    in_rf = (pkt.lam >= rfb[0]) & (pkt.lam < rfb[-1])
    lum_half = (pkt.lum * (pkt.alive & in_rf)) * inv_sqrt
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=sim.device) * tot
    bin_map = torch.tensor(opts.rf_bin_map, dtype=torch.int32,
                           device=sim.device)
    args = (tabs, pkt.pos, pkt.dir, pkt.alive, rec, cells, lum_half, tau_int,
            tb, inv_sqrt)
    kw = dict(n_groups=n_groups, lane=lane, bin_map=bin_map, nbins=nbins)
    rf_k, s_k, c_k, f_k = ml.sweep_deposit(*args, **kw)
    rf_p, s_p, c_p, f_p = ml.sweep_deposit_plain(*args, **kw)
    torch.cuda.synchronize()
    what = f"kernel 5, 32 groups ({ncells} Voronoi cells, 73^3 raster)"
    require(int(f_p.sum()) > B // 2, f"{what} test rays interact")
    require(bool(torch.equal(f_k, f_p)), f"{what} found identical")
    require(bool(torch.equal(s_k[f_k], s_p[f_p])), f"{what} s_int identical")
    require(bool(torch.equal(c_k, c_p)), f"{what} interaction cells equal")
    require(rf_k.shape == rf_p.shape == (nbins, ncells), f"{what} RF rows")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-6 * rf_max,
            f"{what} rf error {rf_err} <= 1e-6 * {rf_max}")
    rows_lit = int((rf_p.abs().sum(dim=1) > 0).sum())
    require(rows_lit == nbins, f"{what} fills the 25 bins' rows ({rows_lit})")
    g, smin, smax = lane
    dep = (tabs, pkt.pos, pkt.dir, g, smin, smax, rec, cells, lum_half,
           tau_int, tb, inv_sqrt, n_groups, bin_map, nbins)
    del rf_p
    plain_ms = cuda_ms(lambda: ml._deposit_plain(*dep), reps=3)
    torch.cuda.empty_cache()
    n_live = int(ml._plan_substeps(tabs, pkt.pos, pkt.dir, g, smin,
                                   smax)[3].sum())
    out["mlsweep_deposit"] = dict(
        max_abs_err=rf_err, rf_max=rf_max, err_of_max=rf_err / rf_max,
        n_groups=n_groups, rows=nbins, rows_lit=rows_lit, leaves=ncells,
        shared_table=False, live_pairs=n_live,
        live_share=n_live / (tabs.n_steps * B),
        ms=cuda_ms(lambda: ml._deposit_cuda(*dep)),
        device_ms=device_ms(lambda: ml._deposit_cuda(*dep))["ours"],
        plain_ms=plain_ms, library_ms=None,
        **bound(lane_bytes(B, 0) + 8 * B + n_live * (3 * 4 + 3 * 4 + 4)
                + 2 * tabs.n_steps * 4 + n_groups * 4 + nbins * ncells * 4
                + 8 * B,
                n_live * (OPS_SLAB + 3 + 3 * (OPS_SUB + OPS_DEP))))
    # detect at the first scattering peel-off of these lanes
    cfg, itab = sim.instruments[0], sim._inst_tabs[0]
    contrib = torch.tensor(rs.uniform(0.0, 1e-3, B), dtype=torch.float32,
                           device=sim.device)
    out["detect"] = check_detect(torch, cfg, itab, pkt.lam,
                                 pkt.pos + s_p[:, None] * pkt.dir, contrib,
                                 f_p, 2)
    emit({"phase": "kernels_b4", "batch": B, "fine_grid": list(tabs.n),
          "n_steps": tabs.n_steps, "run": ml.RUN, "cells": ncells, **out})
    return out


def b4_gaps(acc_c, acc_g, rf_c, rf_g) -> dict:
    """Config 4's gaps between a CPU and a GPU run (B4_BOUNDS): the primary
    SED kinds and the RF as shares of each maximum, the secondary kinds'
    sums, the frame's rows as shares of the brightest pixel."""
    from skirt9_tpu_torch.instruments import distant as dinst
    rel = lambda g, c: float((g.double().cpu() - c.double()).abs().max()
                             / c.double().abs().max())
    sed_c, sed_g = acc_c["sed"].double(), acc_g["sed"].double().cpu()
    out = {"rf_err_of_max": rel(rf_g, rf_c)}
    primary = (dinst.KIND_TRANSPARENT, dinst.KIND_PRIMARY_DIRECT,
               dinst.KIND_PRIMARY_SCATTERED)
    for k in range(sed_c.shape[0]):
        require(float(sed_c[k].abs().max()) > 0, f"SED kind {k} lit")
        name = dinst.KIND_NAMES[k]
        out[f"{name}_err_of_max"] = rel(sed_g[k], sed_c[k])
        out[f"{name}_sum_rel_err"] = abs(float(sed_g[k].sum())
                                         / float(sed_c[k].sum()) - 1.0)
        if k in primary:
            require(out[f"{name}_err_of_max"] <= B4_BOUNDS["primary"],
                    f"config 4 {name} SED {out[f'{name}_err_of_max']} <= "
                    f"{B4_BOUNDS['primary']}")
        else:
            require(out[f"{name}_sum_rel_err"] <= B4_BOUNDS["secondary_sum"],
                    f"config 4 {name} SED sum {out[f'{name}_sum_rel_err']} "
                    f"<= {B4_BOUNDS['secondary_sum']}")
    require(out["rf_err_of_max"] <= B4_BOUNDS["primary"],
            f"config 4 RF {out['rf_err_of_max']} <= {B4_BOUNDS['primary']}")
    out["frame_err"] = rel(acc_g["frame"], acc_c["frame"])
    require(out["frame_err"] <= B4_BOUNDS["frame"],
            f"config 4 frame {out['frame_err']} <= {B4_BOUNDS['frame']}")
    return out


def phase_draw_for_draw_b4(torch) -> dict:
    """The reduced config 4 (bench4.ski at 8,192 packets in batches of
    4,096, which the 32 lane groups round to one batch of 32,768 lanes a
    segment; 4 events; the 73^3 raster) through run_with_dust_emission on
    the CPU (plain versions) and on the GPU (kernels 4, 5 and detect
    launched, no other sweep), the same seed: iterations equal, L_dust
    within 1e-4, the gaps within B4_BOUNDS."""
    runs = {}
    for device in ("cpu", "cuda"):
        sim = config4(device, **B4_SMALL)
        run = lambda: sim.run_with_dust_emission(verbose=False)
        if device == "cuda":
            out, launches = drive(ML + DETECT, ML_NOT_PATH, run)
        else:
            out = run()
        runs[device] = (sim, *out)
    (sc, rfc, ac, ic), (sg, rfg, ag, ig) = runs["cpu"], runs["cuda"]
    require(ic["iterations"] == ig["iterations"],
            f"draw-for-draw (config 4) iterations {ic['iterations']}, "
            f"{ig['iterations']}")
    e_l = abs(ig["L_dust"] / ic["L_dust"] - 1.0)
    require(e_l <= 1e-4, f"draw-for-draw (config 4) L_dust {e_l} <= 1e-4")
    res = {"phase": "draw_for_draw_b4", "cells": sc.grid.ncells,
           "raster": list(sc._sweep_tabs.n), **B4_SMALL, "lanes": 32768,
           "iterations": ic["iterations"], "L_dust_rel_err": e_l,
           "bounds": B4_BOUNDS, **b4_gaps(ac[0], ag[0], rfc, rfg),
           "segments": [s[0] for s in sg.last_stats["segments"]],
           "launches": launches}
    emit(res)
    return res


def bench4_gates(sim, sed, T, strict: bool = True) -> dict:
    """Every gate of test_bench4_* (tests/test_reference_parity.py:
    376-458) against tests/golden/bench4_*: the stellar luminosity between
    0.9e8 and 1.2e8 Lsun, the SED column medians and the integrated total,
    the dust temperature at the golden cells matched to the nearest site
    (median and mass-weighted mean within 8%), and the cell volumes
    (median within 1e-3, 99% within 2%). sed: the SED file's columns; T:
    (ncells,) dust temperature [K]. strict: raise on a failed gate, else
    report it (`passed`)."""
    from scipy.spatial import cKDTree
    res, failed = {}, []

    def gate(name, value, ok):
        res[name] = value
        if not ok:
            failed.append(name)
            require(not strict, f"bench4 {name} {value}")

    L = sim.sources[0].luminosity / L_SUN_B4
    gate("source_luminosity_lsun", L, 0.9e8 < L < 1.2e8)
    ref = np.loadtxt(os.path.join(GOLDEN, "bench4_i0_sed.dat"))
    require(sed.shape[0] == ref.shape[0], "40 SED rows")
    require(bool(np.allclose(sed[:, 0], ref[:, 0], rtol=1e-3)),
            "SED wavelengths")
    for col, name, tol in ((2, "transparent", 0.05), (3, "primarydirect", 0.1),
                           (4, "primaryscattered", 0.15),
                           (5, "secondarydirect", 0.15)):
        hi = ref[:, col] > 0.05 * ref[:, col].max()
        med = float(np.median(sed[hi, col] / ref[hi, col]))
        gate(f"{name}_median_ratio", med, abs(med - 1.0) < tol)
    lam = ref[:, 0]
    tot = float(np.trapezoid(sed[:, 1], lam) / np.trapezoid(ref[:, 1], lam))
    gate("total_ratio", tot, abs(tot - 1.0) < 0.1)
    with gzip.open(os.path.join(GOLDEN, "bench4_cellprops.dat.gz"),
                   "rt") as f:
        props = np.loadtxt(f)
    T_ref = np.loadtxt(os.path.join(GOLDEN, "bench4_T_dust_T.dat"))[:, 1]
    sites = sim.grid.sites.double().cpu().numpy()
    _, idx = cKDTree(sites).query(props[:, 1:4] * PC)
    T_at, rho = T[idx], props[:, 6]
    ok = (rho > 0) & (T_ref > 1.0) & (T_at > 1.0)
    gate("cells_compared", int(ok.sum()), ok.sum() > 1000)
    med = float(np.median(T_at[ok] / T_ref[ok]))
    gate("T_median_ratio", med, abs(med - 1.0) < 0.08)
    w = (rho * props[:, 4])[ok]
    mw = float(np.sum(T_at[ok] * w) / np.sum(T_ref[ok] * w))
    gate("T_mass_weighted_ratio", mw, abs(mw - 1.0) < 0.08)
    vr = sim.grid.volumes()[idx] / (props[:, 4] * PC ** 3)
    vmed = float(np.median(np.abs(vr - 1.0)))
    gate("volume_median_rel_err", vmed, vmed < 1e-3)
    v99 = float((np.abs(vr - 1.0) < 0.02).mean())
    gate("volume_share_within_2pc", v99, v99 > 0.99)
    res["passed"] = not failed
    res["failed"] = failed
    return res


def _b4_run_gates(torch, sim, rf, accs, strict: bool = True) -> dict:
    from skirt9_tpu_torch.utils.fits import read_fits
    require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0,
            "RF finite and non-negative")
    with tempfile.TemporaryDirectory() as tmp:
        paths = sim.write_outputs(accs, "b4", tmp)
        sed = np.loadtxt(paths[0])
        cube, _ = read_fits(paths[1])
    require(cube.shape == (40, 64, 64) and bool(np.isfinite(cube).all())
            and cube.max() > 0, "frame FITS finite and lit")
    return bench4_gates(sim, sed, sim.dust_temperature(rf)[:, 0],
                        strict=strict)


def phase_full_width_b4(torch, smi: str):
    """Config 4 at bench_config4's width (bench.py:152-172: 2^19 packets in
    batches of 2^16, 24 events, seed 0), a warm-up run and a timed run on
    the same object: kernels 4, 5 and detect launched, kernels 1, 2, 6 and
    7 not; packets/s as bench.py counts them, packets x (1 + iterations +
    [L_dust > 0]); each segment's seconds and events; every gate of
    test_bench4_*; then the same gates at that test's own width (B4_TEST),
    reported. Also the host set-up: the Voronoi build and the raster.
    Returns the launches and the run's SED, dust temperatures and rate,
    which full_width_b4_walk sets beside the exact walk's."""
    from skirt9_tpu_torch.grids import voronoi
    from skirt9_tpu_torch.transport import raster
    t0 = time.perf_counter()
    sim = config4("cuda")
    setup_s = time.perf_counter() - t0
    sites = sim.grid.sites.double().cpu().numpy()
    ext = tuple(zip(sim.grid.box_lo.double().cpu().numpy(),
                    sim.grid.box_hi.double().cpu().numpy()))
    t0 = time.perf_counter()
    voronoi.build_voronoi(sites, ext)
    voronoi_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raster.build_tables(sim.grid, sim.medium)
    raster_s = time.perf_counter() - t0
    require(type(sim._sweep_tabs).__name__ == "MLTables",
            "bench4 builds MLTables (its raster)")
    one_batch(sim, sim.run_with_dust_emission)            # warm-up
    t0 = time.perf_counter()
    (rf, accs, info), launches = drive(
        ML + DETECT, ML_NOT_PATH,
        lambda: sim.run_with_dust_emission(verbose=False))
    dt = time.perf_counter() - t0
    stats = dict(sim.last_stats)
    n_pk = sim.num_packets
    packets = n_pk * (1 + info["iterations"] + int(info["L_dust"] > 0))
    gates = _b4_run_gates(torch, sim, rf, accs)
    with tempfile.TemporaryDirectory() as tmp:
        raster = {"sed": np.loadtxt(sim.write_outputs(accs, "b4", tmp)[0]),
                  "T": sim.dust_temperature(rf)[:, 0],
                  "packets_per_s": packets / dt}
    events = sum(seg[3] for seg in stats["segments"])
    tabs = sim._sweep_tabs
    small = config4("cuda", **B4_TEST)
    rf_t, accs_t, info_t = small.run_with_dust_emission(verbose=False)
    gates_test = _b4_run_gates(torch, small, rf_t, accs_t, strict=False)
    res = {"phase": "full_width_b4", "cells": sim.grid.ncells,
           "raster": list(tabs.n), "n_steps": tabs.n_steps,
           "packets": n_pk, "batch": sim.batch_size, "rf_bins": rf.shape[1],
           "packets_per_s": packets / dt, "seconds": dt,
           "iterations": info["iterations"], "L_dust": info["L_dust"],
           "L_abs_primary": info["L_abs_primary"],
           "L_dust_over_L_abs_primary": info["L_dust"] / info["L_abs_primary"],
           "segments": [{"name": n, "packets": p, "seconds": t, "events": e}
                        for n, p, t, e in stats["segments"]],
           "events": events, "launches": launches,
           "kernel_launches_per_event": sum(launches.values()) / events,
           "host_setup_s": setup_s, "voronoi_build_s": voronoi_s,
           "raster_build_s": raster_s, **gates,
           "test_width": dict(B4_TEST, iterations=info_t["iterations"],
                              **gates_test),
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit(res)
    return launches, raster


def phase_breakdown_b4(torch) -> None:
    """Config 4 with one batch of 2^16 packets per segment under
    torch.profiler (host_per_event): device operations, stream syncs and
    host copies per event, busy and idle shares, the kernels that take the
    most device time."""
    prof = host_per_event(
        torch, config4("cuda", num_packets=B_B4),
        lambda s: s.run_with_dust_emission(verbose=False))
    emit({"phase": "breakdown_b4", "packets": B_B4, **prof})


# ------------------------------------------------------------- scan march

MARCH = ("march_uniform", "march_mesh", "march_voronoi")
MARCH_TREE = ("march_octree", "march_bintree")
MARCH_CURVI = ("march_sphere1d", "march_cylinder2d")
MARCH_AMR = ("march_amr",)
# the sweeps' kernels, none of which a march path launches
SWEEPS = RESIDENT + XL + ML + NOT_PATH
# f32 operations per walked (step, lane) in csrc/march.cu: a Cartesian step
# (the three exit distances, the least, the move, the neighbour index), and
# per neighbour of a Voronoi step (the bisector's normal, midpoint, two dot
# products and the division) plus its wall test and move
OPS_MARCH = {"march_uniform": 36, "march_mesh": 33, "march_voronoi": 24,
             # the sphere's two dot products, the quadratics of both
             # borders (two square roots), the choice and the move; the
             # cylinder's three in-plane sums, both quadratics (two square
             # roots, two divisions), the plane's division, the least of
             # three and the move
             "march_sphere1d": 24, "march_cylinder2d": 40}
OPS_MARCH_WALL = 24
# of a tree step (the exit distances, the least, the move and the nudge,
# the root box test), and per level of the descent (an octree's three
# comparisons and two adds, a bintree's one)
OPS_TREE_STEP = 30
OPS_TREE_LEVEL = {"march_octree": 5, "march_bintree": 2}
# per level of an adaptive mesh's descent: per axis the offset, the
# division by the node's span, the product by its subdivisions, the
# truncation and two clamps, and the child's flat index
OPS_AMR_LEVEL = 22
# bench3 with explicit absorption: the interaction sampled on the
# scattering depth, so the gate declines the tree raster's XL tables and
# the octree marches
B3_EXPLICIT = {'forceScattering="true"':
               'forceScattering="true" explicitAbsorption="true"'}
B3_BINTREE = {'treeType="OctTree"': 'treeType="BinTree"'}
B3_RF4 = {'numWavelengths="25"': 'numWavelengths="4"'}
# the reduced configurations of tests/test_torch_config_march.py: ski file,
# edits (a "tree" entry, its maxLevel, replaces the Cartesian grid by a
# density octree: tree_edits), run sizes, dust emission, the kernels the
# card must launch. The Cartesian and Voronoi cases drop their sweep
# tables and march; the trees keep theirs, and the engine chain gives
# each its engine: bench3 with explicit absorption and bench6 with a
# varying temperature march, the moving bench5 and bench7 run on the
# tree's XL raster, the static bench5 on the tree sweep
MARCH_SMALL = {
    "bench1_explicit_absorption": ("bench1", {
        'numBins="32"': 'numBins="16"', 'forceScattering="true"':
        'forceScattering="true" explicitAbsorption="true"'},
        dict(num_packets=4096, batch_size=4096, max_events=8), False,
        ("march_uniform",)),
    "bench1_sympow_mesh": ("bench1", {
        '<LinMesh numBins="32"/>': '<SymPowMesh numBins="16" ratio="8"/>'},
        dict(num_packets=4096, batch_size=4096, max_events=8), False,
        ("march_mesh",)),
    "bench4_walk": ("bench4", {
        'numWavelengths="25"': 'numWavelengths="4"'},
        dict(num_packets=2048, batch_size=2048, max_events=3), True,
        ("march_voronoi",)),
    "bench2_explicit_absorption": ("bench2", {
        'numBins="32"': 'numBins="8"', 'forceScattering="true"':
        'forceScattering="true" explicitAbsorption="true"'},
        dict(num_packets=4096, batch_size=4096, max_events=4), True,
        ("march_uniform",)),
    "bench6_varying_T": ("bench6", {},
                         dict(num_packets=2048, batch_size=2048,
                              max_events=8), False, ("march_uniform",)),
    "bench5_dust": ("bench5", {
        '<ElectronMix includePolarization="true"/>':
        '<MeanFileDustMix filename="mrn_mean.txt"/>',
        'numBins="32"': 'numBins="8"'},
        dict(num_packets=2048, batch_size=2048, max_events=6), False,
        ("march_uniform",)),
    "bench3_explicit_absorption": (
        "bench3", dict(B3_SMALL, **B3_EXPLICIT, **B3_RF4),
        dict(num_packets=4096, batch_size=4096, max_events=8), True,
        ("march_octree",)),
    "bench3_bintree_explicit_absorption": (
        "bench3", dict(B3_SMALL, **B3_EXPLICIT, **B3_BINTREE, **B3_RF4),
        dict(num_packets=4096, batch_size=4096, max_events=8), True,
        ("march_bintree",)),
    "bench5_tree_moving": ("bench5", {"tree": 3},
                           dict(num_packets=4096, batch_size=1024,
                                max_events=8), False, XL),
    "bench5_tree_static": ("bench5", dict({"tree": 3}, **B5_STATIC),
                           dict(num_packets=4096, batch_size=1024,
                                max_events=8), False, ML_PASS1),
    "bench6_tree_varying_T": ("bench6", {"tree": 3},
                              dict(num_packets=2048, batch_size=2048,
                                   max_events=8), False, ("march_octree",)),
    "bench7_tree": ("bench7", {"tree": 3},
                    dict(num_packets=2048, batch_size=2048, max_events=16),
                    False, XL),
    # geometric sources (GEOMETRIC: generated ski files): the galaxy on a
    # 16x16 cylinder and the Ivezic shell on a 40-shell sphere march, on a
    # 16^3 uniform grid the resident sweep (kernels 1-2), on a maxLevel-4
    # density octree with a spiral dust disk the tree sweep (kernels 4-5),
    # and a combined, rotated and clipped source on the cylinder
    "disk_cyl_small": ("disk_cyl_small", {}, dict(
        num_packets=4096, batch_size=4096, max_events=8), False,
        ("march_cylinder2d",)),
    "ivezic_sphere1d": ("ivezic_sphere1d", {}, dict(
        num_packets=4096, batch_size=4096, max_events=8), False,
        ("march_sphere1d",)),
    "geometric_cartesian": ("geometric_cartesian", {}, dict(
        num_packets=4096, batch_size=4096, max_events=8), False, RESIDENT),
    "disk_tree_small": ("disk_tree_small", {}, dict(
        num_packets=4096, batch_size=4096, max_events=8), False, ML),
    "decorated_cyl": ("decorated_cyl", {}, dict(
        num_packets=4096, batch_size=4096, max_events=8), False,
        ("march_cylinder2d",))}
# CPU against card on them: the RF and the SEDs within 2e-5 of their
# maxima, a one-bin SED within 1e-4 (the f32 sum of every detection into
# one entry: the CPU's index_add_ in lane order strays ~1e-5 by itself at
# 4,096 lanes, the card's atomics in another order, as `draw_for_draw`
# holds config 1), after dust emission the secondary light by its sums;
# bench6's Lyman-alpha light as config 6's (B6_BOUNDS: the rejection
# sampler's tan and atan differ by an ulp between the devices), bench7's
# as config 7's (B7_BOUNDS), the polarized bench5 as config 5's
# (B5_BOUNDS, its other rows 2e-5)
MARCH_BOUNDS = {"primary": 2e-5, "one_bin": 1e-4, "secondary_sum": 1e-3}


def march_config(name, device, directory):
    """One reduced march configuration (MARCH_SMALL) through the port's
    load_ski, as the CPU test builds it from the reference: the Cartesian
    and Voronoi cases without sweep tables (no bin-pure strata), the
    Voronoi grid walked exactly, bench6's gas temperature rising 1x to 2x
    over its occupied cells, bench2 and bench3 with one self-absorption
    iteration; a generated configuration (GEOMETRIC) keeps the sweep
    tables of a uniform grid whose case must launch kernels 1-2. Returns
    (sim, dust emission)."""
    import dataclasses
    from skirt9_tpu_torch.config.ski import load_ski
    ski, edits, run, dust, must = MARCH_SMALL[name]
    edits = dict(edits)
    tree = edits.pop("tree", None)
    if tree is not None:
        edits.update(tree_edits(ski, tree))
    path = geometric_ski(ski, directory) if ski in GEOMETRIC else \
        edited_ski(ski, directory, edits, out=name)
    sim = load_ski(path, device=device, **run)
    if ski == "bench4":
        sim = dataclasses.replace(sim, options=dataclasses.replace(
            sim.options, raster_fallback=False))
    if ski == "bench6":
        sim = temperature_ramp(sim)
    if ski in ("bench2", "bench3"):
        sim.iterate_secondary, sim.max_iterations = True, 1
    if type(sim.grid).__name__ not in ("OctreeGrid", "BinTreeGrid") and \
            not set(must) & set(RESIDENT):
        sim._sweep_tabs = None
    return sim, dust


def temperature_ramp(sim):
    """The simulation with its gas temperature rising 1x to 2x over the
    occupied cells (Lya at many temperatures: the Voigt opacity per cell,
    on the march)."""
    import dataclasses
    import torch
    T = sim.medium.temperature.clone()
    occ = sim.medium.nd[:, 0] > 0
    T[occ] *= torch.linspace(1.0, 2.0, int(occ.sum()), device=T.device)
    return dataclasses.replace(sim, medium=sim.medium._replace(
        temperature=T))


def march_gaps(out_c, out_g, dust: bool, bounds=None) -> dict:
    """CPU against card on a march configuration (MARCH_BOUNDS): each
    primary SED kind and the RF within 2e-5 of its maximum (a one-bin SED
    1e-4); after dust emission the secondary kinds by their sums within
    1e-3. bounds: other limits by gap name ("rf", "sed2", ...)."""
    bounds = bounds or {}
    from skirt9_tpu_torch.instruments import distant as dinst
    rel = lambda g, c: float((g.double().cpu() - c.double()).abs().max()
                             / max(float(c.double().abs().max()), 1e-300))
    acc_c, acc_g = out_c[1][0], out_g[1][0]
    gaps = {}
    if out_c[0] is not None:
        gaps["rf"] = rel(out_g[0], out_c[0])
        require(gaps["rf"] <= bounds.get("rf", MARCH_BOUNDS["primary"]),
                f"march RF {gaps['rf']}")
    secondary = (dinst.KIND_SECONDARY_DIRECT, dinst.KIND_SECONDARY_SCATTERED)
    for k in range(acc_c["sed"].shape[0]):
        c, g = acc_c["sed"][k], acc_g["sed"][k]
        if dust and k in secondary:
            cs_, gs_ = float(c.double().sum()), float(g.double().sum())
            e = 0.0 if cs_ == gs_ == 0.0 else abs(gs_ / max(cs_, 1e-300)
                                                  - 1.0)
            gaps[f"sed{k}_sum"] = e
            require(e <= MARCH_BOUNDS["secondary_sum"],
                    f"march secondary SED {k} sum {e}")
        elif float(c.abs().max()) > 0:
            gaps[f"sed{k}"] = rel(g, c)
            limit = bounds.get(f"sed{k}", MARCH_BOUNDS[
                "primary" if c.numel() > 1 else "one_bin"])
            require(gaps[f"sed{k}"] <= limit,
                    f"march SED {k} {gaps[f'sed{k}']} <= {limit}")
    return gaps


def phase_draw_for_draw_march(torch, phase="draw_for_draw_march",
                              names=None) -> dict:
    """MARCH_SMALL (the cases `names`, by default those of no generated
    configuration) on the CPU (plain versions) and on the card (kernels),
    the same seed: march_gaps, bench6 and bench7 by sed_gaps within
    B6_BOUNDS and B7_BOUNDS, the polarized bench5 by b5_errors within
    B5_BOUNDS; each case's kernels and detect launched on the card, and
    neither another march mode nor a sweep outside its engine."""
    res, launches = {}, {}
    every = SWEEPS + MARCH + MARCH_TREE + MARCH_CURVI
    names = names or [n for n in MARCH_SMALL if n not in GEO_CASES]
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            ski, _, _, _, must = MARCH_SMALL[name]
            outs = {}
            for device in ("cpu", "cuda"):
                sim, dust = march_config(name, device, tmp)
                run = (lambda: sim.run_with_dust_emission(verbose=False)) \
                    if dust else (lambda: sim.run_primary(verbose=False))
                if device == "cuda":
                    outs[device], n = drive(
                        must + DETECT, tuple(k for k in every
                                             if k not in must), run)
                    launches[name] = {k: v for k, v in n.items() if v}
                else:
                    outs[device] = run()
            acc_c, acc_g = outs["cpu"][1][0], outs["cuda"][1][0]
            if ski in ("bench6", "bench7"):
                res[name] = sed_gaps(acc_c, acc_g)
                hold_gaps(name, res[name],
                          B6_BOUNDS if ski == "bench6" else B7_BOUNDS)
            elif sim.options.polarization:
                res[name] = b5_errors(acc_c, acc_g)
                for k, e in res[name].items():
                    limit = B5_BOUNDS.get(k, MARCH_BOUNDS["primary"])
                    require(e <= limit, f"draw-for-draw ({name}) {k} {e} "
                            f"<= {limit}")
            else:
                res[name] = march_gaps(outs["cpu"], outs["cuda"], dust)
            torch.cuda.empty_cache()
    emit({"phase": phase, "march_bounds": MARCH_BOUNDS,
          "b5_bounds": B5_BOUNDS, "b6_bounds": B6_BOUNDS,
          "b7_bounds": B7_BOUNDS,
          "configs": {k: dict(zip(("ski", "edits", "run", "dust", "must"),
                                  MARCH_SMALL[k])) for k in names},
          "gaps": res, "launches": launches})
    return launches


def leaf_depth(grid):
    """(ncells,) levels of the descent that ends in each leaf: an octree
    leaf's halvings of the root box along x, a bintree leaf's along all
    three axes."""
    import torch
    ratio = ((grid.box_hi - grid.box_lo)[None, :].double()
             / (grid.cell_hi - grid.cell_lo).double())
    lv = torch.round(torch.log2(ratio))
    return lv[:, 0] if type(grid).__name__ == "OctreeGrid" else lv.sum(dim=1)


def march_cost(name, grid, cells, walked) -> tuple:
    """The bytes of a march mode's grid tables and the f32 operations of
    its walked (step, lane) pairs (cells, walked: the plain version's (S,
    B) cells and walked mask), with the keys that describe them: a tree
    step descends to its next leaf, a Voronoi step tests every
    neighbour."""
    import torch
    n = int(walked.sum())
    if name in MARCH_AMR:
        depth = amr_leaf_depth(grid)[cells.long()][walked]
        tables = sum(t.numel() * t.element_size() for t in grid
                     if isinstance(t, torch.Tensor))
        ops = float((OPS_TREE_STEP + OPS_AMR_LEVEL * depth).sum())
        return tables, ops, dict(leaves=grid.ncells, levels=grid.depth,
                                 mean_depth=float(depth.double().mean()))
    if name in MARCH_TREE:
        depth = leaf_depth(grid)[cells.long()][walked]
        tables = sum(t.numel() * t.element_size() for t in grid[:-2]
                     if isinstance(t, torch.Tensor))
        ops = float((OPS_TREE_STEP + OPS_TREE_LEVEL[name] * depth).sum())
        return tables, ops, dict(leaves=grid.ncells, levels=grid.levels,
                                 mean_depth=float(depth.double().mean()))
    if name == "march_voronoi":
        return (12 * grid.ncells + 4 * grid.neighbors.numel(),
                n * (OPS_MARCH[name] * grid.neighbors.shape[1]
                     + OPS_MARCH_WALL), {})
    if name == "march_clumpy":
        sph = grid.sph
        tables = 4 * (sum(t.numel() for t in sph if torch.is_tensor(t))
                      + 4 * grid.n_clumps)
        return tables, n * (OPS_MARCH[name] + OPS_CLUMP * grid.n_clumps), \
            dict(clumps=grid.n_clumps)
    if name in MARCH_CURVI + MARCH_POLAR:
        tables = 4 * sum(t.numel() for t in grid if torch.is_tensor(t))
        return tables, n * OPS_MARCH[name], {}
    if name == "march_tetra":
        return (4 * (12 + 4 + 4) * grid.ncells, n * OPS_MARCH[name], {})
    tables = 4 * (sum(grid.shape) + 3) if name == "march_mesh" else 24
    return tables, n * OPS_MARCH[name], {}


def _march_check(torch, name, grid, pos, dirn, cell, S, mask) -> dict:
    """The march kernel in one mode against its plain version on the same
    CUDA tensors: a tree mode bit-identical, cells and lengths, on every
    (step, lane); a Cartesian or Voronoi mode with its cells on every
    (step, lane) pair (the lanes differing counted, at most 1e-4 of them)
    and each lane's summed length within 1e-6. Timed by CUDA events and
    the profiler (a dropped kernel event flagged), beside the plain
    version; the bound from the bytes of the (S, B) tables, the lanes'
    inputs and the grid's tables, or the operations (march_cost)."""
    from skirt9_tpu_torch.kernels import build as kb
    from skirt9_tpu_torch.transport import march as mr
    B = pos.shape[0]
    kb.reset_launches()
    ck, dk = mr._march_cuda(grid, pos, dirn, cell, S, mask)
    require(kb.LAUNCHES[name] == 1, f"{name} launched once")
    # the plain version once, timed: a step is dozens to hundreds of
    # launches, S of them a march
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    cp, dp = mr.march_geometry_plain(grid, pos, dirn, cell, S, mask)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    exact = name in MARCH_TREE + MARCH_CURVI + MARCH_AMR + MARCH_POLAR \
        + MARCH_TETRA + MARCH_CLUMPY
    off = ((ck != cp) | (dk != dp)) if exact else ck != cp
    lanes_off = int(off.any(dim=0).sum())
    require(lanes_off <= (0 if exact else 1e-4 * B),
            f"{name}: {lanes_off} lanes' cells{' or lengths' * exact} "
            "differ")
    sk, sp = dk.double().sum(dim=0), dp.double().sum(dim=0)
    ds_err = float(((sk - sp).abs() / sp.abs().clamp_min(1e-300)).max())
    require(ds_err <= 1e-6, f"{name}: summed lengths within 1e-6 ({ds_err})")
    walked = dp > 0
    require(int(walked.sum()) > B, f"{name} walks ({int(walked.sum())})")
    tables, ops, extra = march_cost(name, grid, cp, walked)
    nbytes = S * B * 8 + B * (12 + 12 + 4 + 1) + tables
    kern = lambda: mr._march_cuda(grid, pos, dirn, cell, S, mask)
    dev = device_ms(kern)
    return dict(max_abs_err=float((dk - dp).abs().max()),
                ds_sum_rel_err=ds_err, lanes_cells_differ=lanes_off,
                lanes=B, steps=S, walked_pairs=int(walked.sum()),
                live_share=float(walked.float().mean()),
                max_walk=int(walked.sum(dim=0).max()), ms=cuda_ms(kern),
                device_ms=dev["ours"] or None,
                profiler_dropped=dev["ours"] == 0,
                device_launches=dev["launches"], plain_ms=plain_ms,
                library_ms=None, **extra, **bound(nbytes, ops))


def phase_kernels_march(torch) -> dict:
    """The march kernel's three modes against their plain versions at the
    main paths' shapes (_march_check)."""
    import dataclasses
    from skirt9_tpu_torch.grids import meshes
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.sources import base as src
    out = {}
    sim = config4("cuda")
    sim = dataclasses.replace(sim, options=dataclasses.replace(
        sim.options, raster_fallback=False))
    require(sim._sweep_tabs is None, "bench4 without its raster")
    dev = sim.device
    pkt = src.launch_batch(sim.sources[0], sim._src_tabs[0], sim.grid,
                           rng.seed_key(sim.seed, dev),
                           torch.arange(B_B4, device=dev), sim.num_packets)
    S = sim.options.max_steps
    require(S == 76, f"bench4's march takes 76 steps ({S})")
    out["march_voronoi"] = _march_check(torch, "march_voronoi", sim.grid,
                                        pkt.pos, pkt.dir, pkt.cell, S,
                                        pkt.alive)
    del sim, pkt
    rs = np.random.default_rng(21)
    sym = meshes.scale(meshes.sym_pow_mesh(32, 8.0), -1.2 * PC, 1.2 * PC)
    for name, meshed in (("march_uniform", None), ("march_mesh", [sym] * 3)):
        sim = config1("cuda", meshes=meshed)
        pos, dirn, _, inside = sphere_rays(torch, sim, rs, B_FULL)
        S = sim.options.max_steps
        require(S == 99, f"config 1's march takes 99 steps ({S})")
        out[name] = _march_check(torch, name, sim.grid, pos, dirn,
                                 sim.grid.locate(pos), S, inside)
    torch.cuda.empty_cache()
    emit({"phase": "kernels_march", **out})
    return out


def phase_full_width_b4_walk(torch, smi: str, raster: dict) -> dict:
    """bench4.ski at bench_config4's width with raster_fallback off (the
    exact Voronoi walk, no sweep tables), a warm-up run and a timed run:
    march_voronoi and detect launched, kernels 4-5 and the other sweeps
    not; every bench4 gate strict; packets/s as bench.py counts them; one
    batch per segment profiled (host_per_event); the SED's total column
    and the per-cell dust temperature beside the raster run's (raster:
    full_width_b4's), the raster's chord error, stated and not gated."""
    sim = _walk_sim()
    one_batch(sim, sim.run_with_dust_emission)            # warm-up
    t0 = time.perf_counter()
    (rf, accs, info), launches = drive(
        ("march_voronoi",) + DETECT, SWEEPS + ("march_uniform", "march_mesh"),
        lambda: sim.run_with_dust_emission(verbose=False))
    dt = time.perf_counter() - t0
    stats = dict(sim.last_stats)
    packets = sim.num_packets * (1 + info["iterations"]
                                 + int(info["L_dust"] > 0))
    with tempfile.TemporaryDirectory() as tmp:
        paths = sim.write_outputs(accs, "b4", tmp)
        sed = np.loadtxt(paths[0])
    T = sim.dust_temperature(rf)[:, 0]
    gates = _b4_run_gates(torch, sim, rf, accs)
    events = sum(seg[3] for seg in stats["segments"])
    n_full, sim.num_packets = sim.num_packets, B_B4
    prof = host_per_event(torch, sim,
                          lambda s: s.run_with_dust_emission(verbose=False),
                          warm=True)
    sim.num_packets = n_full
    lit = raster["sed"][:, 1] > 0.05 * raster["sed"][:, 1].max()
    sed_ratio = sed[lit, 1] / raster["sed"][lit, 1]
    dusty = sim.medium.nd[:, 0].cpu().numpy() > 0
    t_ratio = T[dusty] / np.maximum(raster["T"][dusty], 1e-30)
    res = {"phase": "full_width_b4_walk", "cells": sim.grid.ncells,
           "max_steps": sim.options.max_steps, "packets": sim.num_packets,
           "batch": sim.batch_size, "rf_bins": rf.shape[1],
           "packets_per_s": packets / dt, "seconds": dt,
           "iterations": info["iterations"], "L_dust": info["L_dust"],
           "segments": [{"name": n, "packets": p, "seconds": t, "events": e}
                        for n, p, t, e in stats["segments"]],
           "events": events, "launches": {k: v for k, v in launches.items()
                                          if v},
           **gates, "breakdown": prof,
           "walk_vs_raster": {
               "sed_total_ratio_median": float(np.median(sed_ratio)),
               "sed_total_ratio_p5_p95": [float(q) for q in np.quantile(
                   sed_ratio, [0.05, 0.95])],
               "dusty_cells": int(dusty.sum()),
               "T_ratio_median": float(np.median(t_ratio)),
               "T_ratio_p5_p95": [float(q) for q in np.quantile(
                   t_ratio, [0.05, 0.95])],
               "T_share_within_5pc": float((np.abs(t_ratio - 1) < 0.05)
                                           .mean()),
               # cells the raster leaves without deposits: no voxel
               # centre falls in them
               "cells_raster_cold": int((t_ratio > 2.0).sum()),
               "raster_packets_per_s": raster["packets_per_s"]},
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit(res)
    return launches


def _walk_sim(**kw):
    """config4 with raster_fallback off: no sweep tables, the exact walk."""
    import dataclasses
    sim = config4("cuda", **kw)
    sim = dataclasses.replace(sim, options=dataclasses.replace(
        sim.options, raster_fallback=False))
    require(sim._sweep_tabs is None, "bench4 walked exactly")
    return sim


def phase_full_width_b1_march(torch, smi: str, sweep: dict) -> dict:
    """Config 1 at 2^20 packets in batches of 2^17 on the scan march, each
    timed after a warm-up: with explicit absorption on its 32^3 grid
    (march_uniform; config1_gates), and on a 32^3 SymPowMesh grid
    (march_mesh; the transparent SED exact, R < 0.01, the scattered SED
    within 2% of full_width's sweep run, sweep: its gates and rate)."""
    from skirt9_tpu_torch.grids import meshes
    sym = meshes.scale(meshes.sym_pow_mesh(32, 8.0), -1.2 * PC, 1.2 * PC)
    res = {"phase": "full_width_b1_march",
           "sweep_packets_per_s": sweep["packets_per_s"]}
    launches = {}
    for name, mode, kw in (
            ("explicit_absorption", "march_uniform",
             dict(explicit_absorption=True)),
            ("sympow_mesh", "march_mesh", dict(meshes=[sym] * 3))):
        sim = config1("cuda", **kw)
        require(sim._sweep_tabs is None or "meshes" not in kw,
                "the meshed grid has no sweep tables")
        one_batch(sim, sim.run_primary)            # warm-up
        (rf, accs), n = drive((mode,) + DETECT,
                              SWEEPS + tuple(m for m in MARCH if m != mode),
                              lambda: sim.run_primary(verbose=False))
        gates = config1_gates(sim, accs, direct="meshes" not in kw)
        if "meshes" in kw:
            e = abs(gates["scattered"] / sweep["scattered"] - 1.0)
            require(e <= 0.02, f"meshed scattered SED within 2% of the "
                    f"sweep run's ({e})")
            gates["scattered_vs_sweep"] = e
        res[name] = {"packets_per_s": sim.last_rate,
                     "seconds": sim.last_stats["seconds"],
                     "events": sim.last_stats["events"],
                     "launches": {k: v for k, v in n.items() if v}, **gates}
        launches[mode] = n
        del sim
        torch.cuda.empty_cache()
    emit(dict(res, device=torch.cuda.get_device_name(0), nvidia_smi=smi))
    return launches


# ---------------------------------------------------------- trees marched

def _first_event_lanes(torch, sim, B):
    """The positions, directions, cells and alive mask of the first B
    histories of the simulation's first source, as its first event's
    march sees them."""
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.sources import base as src
    pkt = src.launch_batch(sim.sources[0], sim._src_tabs[0], sim.grid,
                           rng.seed_key(sim.seed, sim.device),
                           torch.arange(B, device=sim.device),
                           sim.num_packets)
    return pkt.pos, pkt.dir, pkt.cell, pkt.alive


def phase_kernels_march_tree(torch) -> dict:
    """The march kernel's tree modes against their plain versions
    (_march_check): march_octree on bench3's octree and march_bintree
    on bench3 loaded as a bintree (2^16 lanes at the first event, S =
    256), and march_octree on a level-10 octree (2^16 random lanes)."""
    from skirt9_tpu_torch import device
    from skirt9_tpu_torch.grids.octree import build_octree
    dev = device.resolve("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in (
                ("march_octree", None),
                ("march_bintree", edited_ski("bench3", tmp, B3_BINTREE))):
            sim = config3("cuda", path=path)
            S = sim.options.max_steps
            require(S == 256, f"bench3's march takes 256 steps ({S})")
            pos, dirn, cell, alive = _first_event_lanes(torch, sim, B_B3)
            out[name] = _march_check(torch, name, sim.grid, pos, dirn, cell,
                                     S, alive)
            del sim
    p = np.array([0.1, 0.2, 0.3]) * PC
    deep = build_octree(((-1.2 * PC, 1.2 * PC),) * 3, None, max_level=10,
                        min_level=2, refine_fn=lambda lo, hi, level: np.all(
                            (lo <= p) & (p < hi), axis=-1)).to(dev)
    require(deep.levels == 11, f"the level-10 octree ({deep.levels})")
    rs = np.random.default_rng(23)
    pos = np.concatenate([rs.uniform(-1.2 * PC, 1.2 * PC, (B_B3 // 2, 3)),
                          p + rs.normal(scale=0.01 * PC, size=(B_B3 // 2, 3))])
    d = rs.normal(size=(B_B3, 3))
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    pos, dirn = t32(pos), t32(d / np.linalg.norm(d, axis=1, keepdims=True))
    cell = deep.locate(pos)
    out["march_octree_level10"] = _march_check(
        torch, "march_octree", deep, pos, dirn, cell,
        min(deep.max_steps(), 256), cell >= 0)
    torch.cuda.empty_cache()
    emit({"phase": "kernels_march_tree", **out})
    return out


def config3_march(device, **kw):
    """config 3 with explicitAbsorption (B3_EXPLICIT): the tree raster's
    XL tables built, as the reference builds them, and declined by the
    gate; the octree marches."""
    from skirt9_tpu_torch.transport import lifecycle as lc
    with tempfile.TemporaryDirectory() as tmp:
        sim = config3(device, path=edited_ski("bench3", tmp, B3_EXPLICIT),
                      **kw)
    require(type(sim._sweep_tabs).__name__ == "XLTables"
            and sim.options.explicit_absorption,
            "bench3 with explicit absorption builds its raster's XLTables")
    gate = lc.sweep_gate(sim.medium, sim.options, sim._sweep_tabs,
                         sim._init_rf(), sim.batch_size)
    require(not gate.use_sweep and "explicitAbsorption" in gate.why,
            f"the gate declines the XL tables ({gate.why})")
    return sim


def phase_full_width_b3_march(torch, smi: str, sweep: dict) -> dict:
    """bench3.ski with explicit absorption at bench_config3's width (2^18
    packets in batches of 2^16, 24 events, seed 0), a warm-up run and a
    timed run: march_octree and detect launched, no sweep kernel and no
    other march mode; every bench3 gate; packets/s as bench.py counts them
    beside full_width_b3's tree-sweep run (sweep: its rate and gates);
    one batch per segment profiled (host_per_event)."""
    sim = config3_march("cuda")
    one_batch(sim, sim.run_with_dust_emission)            # warm-up
    t0 = time.perf_counter()
    (rf, accs, info), launches = drive(
        ("march_octree",) + DETECT,
        SWEEPS + MARCH + ("march_bintree",),
        lambda: sim.run_with_dust_emission(verbose=False))
    dt = time.perf_counter() - t0
    stats = dict(sim.last_stats)
    packets = sim.num_packets * (1 + info["iterations"]
                                 + int(info["L_dust"] > 0))
    require(bool(torch.isfinite(rf).all()) and float(rf.min()) >= 0,
            "RF finite and non-negative")
    with tempfile.TemporaryDirectory() as tmp:
        paths = sim.write_outputs(accs, "b3m", tmp)
        sed = np.loadtxt(paths[0])
    gates = bench3_gates(sim, sed, mean_intensity(sim, rf),
                         sim.dust_temperature(rf)[:, 0])
    events = sum(seg[3] for seg in stats["segments"])
    n_full, sim.num_packets = sim.num_packets, B_B3
    prof = host_per_event(torch, sim,
                          lambda s: s.run_with_dust_emission(verbose=False),
                          warm=True)
    sim.num_packets = n_full
    emit({"phase": "full_width_b3_march", "leaves": sim.grid.ncells,
          "max_steps": sim.options.max_steps, "packets": sim.num_packets,
          "batch": sim.batch_size, "rf_bins": rf.shape[1],
          "packets_per_s": packets / dt, "seconds": dt,
          "iterations": info["iterations"], "L_dust": info["L_dust"],
          "L_dust_over_L_abs_primary": info["L_dust"] / info["L_abs_primary"],
          "segments": [{"name": n, "packets": p, "seconds": t, "events": e}
                       for n, p, t, e in stats["segments"]],
          "events": events, "launches": {k: v for k, v in launches.items()
                                         if v},
          **gates, "breakdown": prof, "tree_sweep": sweep,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return launches


def config5_tree(device, **kw):
    """config 5 with its grid replaced by a density octree of levels 2-6
    (tree_edits): 24,571 leaves on a 64^3 voxel raster, which the XL
    contracts take (kinematics leaves the tree sweep)."""
    with tempfile.TemporaryDirectory() as tmp:
        sim = config5(device, path=edited_ski(
            "bench5", tmp, tree_edits("bench5", 6), out="tree"), **kw)
    require(type(sim.grid).__name__ == "OctreeGrid"
            and type(sim._sweep_tabs).__name__ == "XLTables"
            and sim._sweep_tabs.cellmap is not None,
            "bench5 on an octree: its voxel raster's XL tables")
    return sim


def phase_kernels_b5_tree(torch) -> dict:
    """(right after kernels_march_tree, while the profiler is fresh)
    Kernels 6-7 on config5_tree's first event (B = 2^17, its 64^3 voxel
    raster with the cell map), each mode against its plain version on the
    same CUDA tensors: kernel 6's prefix mode (check_prefix_xl); kernel 7's
    prefix mode without an RF, as the loop calls it on bench5 (tau_int a
    uniform share up to 1.1 of each lane's tau: s_int, icell and found
    identical); kernel 6's total mode toward the instrument from the
    interaction points in entry-slab order, as the peel-off calls it
    (within 1e-6 of each lane's tau); detect's Stokes mode at that first
    scattering peel-off (check_detect); and kernel 4's total and prefix
    modes on MARCH_SMALL's static bench5 octree (_dtau_ml, 2^16 rays in
    its box). Each timed by CUDA events and the profiler, beside the plain
    version, with its bound."""
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    sim = config5_tree("cuda")
    tabs = sim._sweep_tabs
    rays, _, n_groups, pre = first_event_xl(torch, sim)
    pos, dirn, _, _, alive, sig = rays
    B = pos.shape[0]
    require(n_groups == 1 and B == B_FULL, f"bench5 on its tree: one lane "
            f"group of 2^17 ({n_groups}, {B})")
    out = {"sweepxl_dtau_prefix": check_prefix_xl(
        torch, "bench5's tree raster", tabs, rays, pre)}

    rec, tb, tot, lane = pre
    u = np.random.default_rng(5).uniform(0.0, 1.1, B)
    tau_int = torch.tensor(u, dtype=torch.float32, device=pos.device) * tot
    act = alive & (tot > 1e-6)
    args = (tabs, pos, dirn, act, rec, None, tau_int, tb, 1.0, lane)
    _, *hit_k = xl.sweep_deposit_prefix(*args)
    _, *hit_p = xl.sweep_deposit_prefix_plain(*args)
    torch.cuda.synchronize()
    s_int, _, found = hit_p
    require(int(found.sum()) > B // 2, "bench5's tree: the rays interact "
            f"({int(found.sum())})")
    for a, b, name in zip(hit_k, hit_p, ("s_int", "icell", "found")):
        require(bool(torch.equal(a, b)), f"bench5's tree: kernel 7 {name} "
                "identical")
    kern = lambda: xl.sweep_deposit_prefix(*args)
    out["sweepxl_deposit_prefix"] = dict(
        max_abs_err=float((hit_k[0] - s_int).abs().max()),
        found_lanes=int(found.sum()), ms=cuda_ms(kern),
        device_ms=device_ms(kern)["ours"] or None,
        plain_ms=cuda_ms(lambda: xl.sweep_deposit_prefix_plain(*args),
                         reps=3), library_ms=None,
        **bound(lane_bytes(B, 0) + 9 * B + tabs.nmax * B * 4 + 12 * B
                + 13 * B, B * (OPS_SLAB + 3 * OPS_SUB + 12)
                + 3 * tabs.nmax * B))
    del hit_k, rec, tb
    torch.cuda.empty_cache()

    kobs = sim._inst_tabs[0]["kobs"]
    hint = int(np.argmax(np.abs(sim.instruments[0].frame_axes()[0])
                         / np.asarray(tabs.h)))
    ipos = pos + s_int[:, None] * dirn
    prm = xl.entry_order(tabs, ipos, hint)
    kdir = kobs.expand(B, 3).contiguous()
    pl = (tabs, ipos[prm].contiguous(), kdir, sig[:, prm].contiguous(),
          found[prm].contiguous(), hint)
    tot_k = xl.sweep_tau_total(*pl)
    tot_p = xl.sweep_tau_total_plain(*pl)
    torch.cuda.synchronize()
    require(int((tot_p > 0).sum()) > B // 2, "bench5's tree: the peel-off "
            "rays see matter")
    rel = float(((tot_k - tot_p).abs() / tot_p.clamp_min(1e-30)).max())
    require(rel <= 1e-6, f"bench5's tree: kernel 6 totals within 1e-6 of "
            f"each lane's tau ({rel})")
    g, smin, smax, _ = sw._prep(tabs, pl[1], kdir, pl[3], pl[4])
    n_act = active_slabs(tabs, pl[1], kdir, torch.full_like(g, hint), smin,
                         smax)
    kern = lambda: xl.sweep_tau_total(*pl)
    out["sweepxl_tau_total"] = dict(
        max_abs_err=float((tot_k - tot_p).abs().max()), max_err_of_tau=rel,
        active_pairs=n_act, ms=cuda_ms(kern),
        device_ms=device_ms(kern)["ours"] or None,
        plain_ms=cuda_ms(lambda: xl.sweep_tau_total_plain(*pl), reps=3),
        library_ms=None,
        **bound(ray_bytes(B, 1) + tabs.nd.numel() * 4 + B * 4,
                B * OPS_LANE + n_act * (OPS_SLAB + 3 * (OPS_SUB + 2) + 3)))
    # detect's Stokes mode at the first scattering peel-off on the tree
    # raster: the interaction points above, each lane's polarized phase
    # and Stokes values toward the instrument, attenuated by the totals
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.ops import stokes as stk
    from skirt9_tpu_torch.sources import base as src
    from skirt9_tpu_torch.transport import lifecycle as lc
    dev = pos.device
    pkt = src.launch_batch(sim.sources[0], sim._src_tabs[0], sim.grid,
                           rng.seed_key(sim.seed, dev),
                           torch.arange(B, device=dev), sim.num_packets)
    perm = xl.lane_order(tabs, pkt.pos, pkt.dir,
                         sw.dominant_axis(tabs, pkt.dir), 1)
    pkt = pkt._replace(**{f: getattr(pkt, f)[perm] for f in pkt._fields})
    require(bool(torch.equal(pkt.pos, pos)), "bench5's tree: the first "
            "event's lanes are the launch batch's, in the loop's order")
    pkt = pkt._replace(pos=ipos)
    tab = sim._inst_tabs[0]
    h = torch.zeros(B, dtype=torch.int64, device=dev)
    contrib, quv = lc.polarized_per_sr(
        pkt, sim.mueller, h, stk.s11_norm(sim.mueller)[h], pkt.lum, kobs,
        lc._detector_normals([tab])[0])
    att = torch.empty_like(tot_p)
    att[prm] = torch.exp(-tot_p)
    res = check_detect(torch, sim.instruments[0], tab, pkt.lam, ipos,
                       contrib * att, found, 2, quv=quv)
    require(res["stokes_v_zero"], "bench5's tree: Stokes V identically 0")
    out["detect"] = res
    del sim, pl
    torch.cuda.empty_cache()
    # kernel 4's tracer and pass-1 modes on the static bench5 octree of
    # MARCH_SMALL (polarization on the tree sweep), 2^16 rays in its box
    with tempfile.TemporaryDirectory() as tmp:
        sim_s, _ = march_config("bench5_tree_static", "cuda", tmp)
        _, more, *_ = _dtau_ml(torch, sim_s, np.random.default_rng(6))
        out.update({f"{k}_static_tree": dict(v, leaves=sim_s.grid.ncells)
                    for k, v in more.items()})
        del sim_s
    emit({"phase": "kernels_b5_tree", "batch": B, **out})
    torch.cuda.empty_cache()
    return out


def los_tau(sim, lam: float) -> float:
    """The optical depth at wavelength lam from the first source toward
    the first instrument (the f32 direction the tracer takes) through the
    grid's cells, in f64 on the host from the cells' boxes and the
    medium's densities: each cell's crossed length on the ray (its slab
    interval; along an axis the ray does not move on, the cell that holds
    the source's coordinate, lo <= x < hi, as locate has it) times its
    extinction coefficient."""
    import torch
    from skirt9_tpu_torch.media import system as msys
    host = lambda t: t.detach().double().cpu().numpy()
    lo, hi = host(sim.grid.cell_lo), host(sim.grid.cell_hi)
    p0 = np.asarray(sim.sources[0].position, np.float32).astype(np.float64)
    k = host(sim._inst_tabs[0]["kobs"])
    t0, t1 = np.zeros(len(lo)), np.full(len(lo), np.inf)
    for a in range(3):
        if k[a] == 0.0:
            held = (lo[:, a] <= p0[a]) & (p0[a] < hi[:, a])
            t1 = np.where(held, t1, -np.inf)
        else:
            ta, tb = (lo[:, a] - p0[a]) / k[a], (hi[:, a] - p0[a]) / k[a]
            t0 = np.maximum(t0, np.minimum(ta, tb))
            t1 = np.minimum(t1, np.maximum(ta, tb))
    sig = host(msys.optics_at(sim.medium, torch.tensor(
        [lam], dtype=torch.float32, device=sim.device)).sigma_ext)[0]
    kappa = host(sim.medium.nd) @ sig
    return float((np.clip(t1 - t0, 0.0, None) * kappa).sum())


# bench5.ski's source: 1 Lsun (SKIRT's 3.839e26 W) of a 5778 K blackbody
# over 0.4-0.8 micron, wavelength bias 0.5 (half the packets log-uniform),
# seen from 100 pc
B5_SOURCE = dict(L=3.839e26, T=5778.0, lo=0.4e-6, hi=0.8e-6, bias=0.5,
                 d=100 * 3.08567758149e16)


def point_source_gates(sim, sed_um, n_sigma: float = 5.0, src=B5_SOURCE,
                       direct: bool = True) -> dict:
    """bench5's transparent and direct SEDs [W/m2/micron] against values
    the port does not compute. The transparent one bin by bin against
    L / (4 pi d^2) times the blackbody's share of each bin over its width,
    within n_sigma of the run's sampling noise there (the wavelength bias's
    weights: per-packet variance int_bin p^2 / q - P^2, p the blackbody's
    pdf, q the biased one, over num_packets), and in total within n_sigma of
    its noise; the direct one over the transparent one, bin by bin, equal
    to exp(-tau) of the line of sight (los_tau) within 1e-4 (both f32 sums
    of the same lanes' detections; with direct). src: the source's
    luminosity, temperature, range, wavelength bias and distance."""
    h, c, kB = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    x = np.geomspace(src["lo"], src["hi"], 400_001)
    p = x ** -5 / np.expm1(h * c / (x * kB * src["T"]))
    p /= np.trapezoid(p, x)
    q = (1 - src["bias"]) * p + src["bias"] / (x * np.log(src["hi"]
                                                          / src["lo"]))
    cum = lambda f: np.concatenate([[0.0], np.cumsum(
        0.5 * (f[1:] + f[:-1]) * np.diff(x))])
    borders = np.asarray(sim.instruments[0].wave_borders, np.float64)
    at = lambda f: np.diff(np.interp(np.clip(borders, src["lo"], src["hi"]),
                                     x, cum(f)))
    P, Q = at(p), at(p * p / q)
    N = sim.num_packets
    flux = src["L"] / (4 * np.pi * src["d"] ** 2)
    want = flux * P / (np.diff(borders) * 1e6)
    lit = P > 0
    ratio = sed_um["transparent"][lit] / want[lit]
    sigma = np.sqrt(np.maximum(Q - P * P, 0.0) / N)[lit] / P[lit]
    z = np.abs(ratio - 1) / sigma
    require(float(z.max()) <= n_sigma, f"transparent SED within {n_sigma} "
            f"sigma of the blackbody in every bin ({float(z.max())})")
    total = float((sed_um["transparent"] * np.diff(borders) * 1e6).sum()
                  / flux)
    sigma_tot = math.sqrt((float(Q.sum()) - 1.0) / N)
    require(abs(total - 1) <= n_sigma * sigma_tot,
            f"transparent SED's integral {total} within {n_sigma} sigma "
            f"({sigma_tot}) of L / (4 pi d^2)")
    out = dict(transparent_max_sigmas=float(z.max()),
               transparent_max_rel_err=float(np.abs(ratio - 1).max()),
               transparent_sigma_range=[float(sigma.min()),
                                        float(sigma.max())],
               transparent_integral=total,
               transparent_integral_sigma=sigma_tot)
    if not direct:
        return out
    att = math.exp(-los_tau(sim, 0.55e-6))
    e_dir = float(np.abs(sed_um["primarydirect"][lit]
                         / sed_um["transparent"][lit] / att - 1).max())
    require(e_dir <= 1e-4, f"direct over transparent SED {e_dir} <= 1e-4 "
            f"from exp(-tau) = {att}")
    return dict(out, los_attenuation=att, direct_over_transparent_err=e_dir)


def phase_full_width_b5_tree(torch, smi: str, uniform: dict) -> dict:
    """bench5 on a maxLevel-6 octree (config5_tree) at bench_config5's
    width, a warm-up run and a timed run: kernels 6-7 and detect (its
    Stokes mode) launched, no march and no other sweep; gated: point_source_gates (the transparent SED against the
    blackbody, the direct one against the line of sight through the
    tree), V identically 0, the SED's R < 0.01 in every bin; reported
    beside full_width_b5's (uniform: its rate, ratios and transparent
    SED): the transparent SED's gap to it (the same histories), and the
    bench5 golden ratios, which the tree, resolving the disk otherwise,
    need not meet."""
    sim = config5_tree("cuda")
    one_batch(sim, sim.run_primary)            # warm-up
    (rf, accs), launches = drive(
        XL + DETECT, RESIDENT + ML + NOT_PATH + MARCH + MARCH_TREE,
        lambda: sim.run_primary(verbose=False))
    stats = dict(sim.last_stats)
    with tempfile.TemporaryDirectory() as tmp:
        sed = _b5_outputs(sim, accs, tmp, "b5tree")[0]
        cols = np.loadtxt(os.path.join(tmp, "b5tree_i0_sed.dat"))
    gates = point_source_gates(sim, sed)
    require(bool(np.all(sed["V"] == 0)), "V identically 0")
    R = cols[:, 10]
    require(float(R.max()) < 0.01, f"SED relative error R {R.max()} < 0.01")
    tr = uniform["transparent_sed"]
    emit({"phase": "full_width_b5_tree", "leaves": sim.grid.ncells,
          "raster": list(sim._sweep_tabs.n), "packets": sim.num_packets,
          "batch": sim.batch_size, "packets_per_s": sim.last_rate,
          "seconds": stats["seconds"], "events": stats["events"],
          "launches": {k: v for k, v in launches.items() if v},
          **gates, "R_max": float(R.max()), "R_median": float(np.median(R)),
          "transparent_vs_uniform": float(np.abs(sed["transparent"] - tr).max()
                                          / np.abs(tr).max()),
          "golden_ratios": bench5_ratios(sed),
          "uniform": {k: v for k, v in uniform.items()
                      if k != "transparent_sed"},
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return launches


def bench5_ratios(sed_um) -> dict:
    """The median ratios of a run's SED [W/m2/micron] to the golden one's
    (tests/test_reference_parity.py:280-353) over the bins above a tenth of
    the golden maximum: the total, transparent, direct, scattered and Q
    columns."""
    g = np.loadtxt(os.path.join(GOLDEN, "bench5_i0_sed.dat"))
    out = {}
    for kind, col in (("transparent", 2), ("primarydirect", 3), ("total", 1),
                      ("primaryscattered", 4), ("Q", 8)):
        m = np.abs(g[:, col]) > 0.1 * np.max(np.abs(g[:, col]))
        out[kind] = float(np.median(sed_um[kind][m] / g[m, col]))
    return out



# ------------------------------------------------- geometric sources, curvi

KPC = 1e3 * PC
# disk_cyl's galaxy: an exponential stellar disk (5000 K) and a flattened
# Sersic bulge (4000 K, 0.3 of the disk's luminosity) in an exponential dust
# disk of face-on tau_V = 1, in a box of R 25 kpc and |z| 4 kpc
GALAXY = dict(L_disk=1e10, T_disk=5000.0, h_r=4.0, h_z=0.35, reff=1.6,
              sersic=4.0, q_bulge=0.6, T_bulge=4000.0, bulge_frac=0.3,
              dust_h_r=6.0, dust_h_z=0.25, tau_v=1.0, r_max=25.0, z_max=4.0,
              lam=(0.1, 3.0), distance_mpc=10.0)
B_GEO = 1 << 16           # the full-width batch of disk_cyl and disk_tree
N_GEO = 1 << 20           # and their packets


def _sigma_v() -> float:
    """The MRN mix's extinction cross section at 0.55 micron [m2]."""
    from skirt9_tpu_torch.media import mixes as mx
    return float(mx.from_file(os.path.join(GOLDEN, "mrn_mean.txt"))
                 .at(0.55e-6)[0])


def dust_disk_number(unit: str = "kpc") -> float:
    """The dust disk's entity count for face-on tau_V through the whole z
    axis: the exponential disk's column at R = 0 is N / (2 pi h_r^2)."""
    g = GALAXY
    h = g["dust_h_r"] * (KPC if unit == "kpc" else PC)
    return g["tau_v"] * 2 * math.pi * h ** 2 / _sigma_v()


def _disk_sources(kind: str, unit: str = "kpc") -> str:
    g = GALAXY
    bb = lambda T: (f'<sed type="SED"><BlackBodySED temperature="{T} K"/>'
                    '</sed>')
    norm = lambda L: ('<normalization type="LuminosityNormalization">'
                      '<IntegratedLuminosityNormalization wavelengthRange='
                      f'"Source" integratedLuminosity="{L:.6g} Lsun"/>'
                      '</normalization>')
    disk = (f'<ExpDiskGeometry scaleLength="{g["h_r"]} {unit}" '
            f'scaleHeight="{g["h_z"]} {unit}"/>')
    bulge = (f'<SpheroidalGeometryDecorator flattening="{g["q_bulge"]}">'
             '<geometry type="Geometry"><SersicGeometry effectiveRadius='
             f'"{g["reff"]} {unit}" index="{g["sersic"]}"/></geometry>'
             '</SpheroidalGeometryDecorator>')
    src = lambda geom, T, L: (
        '<GeometricSource sourceWeight="1" wavelengthBias="0.5"><geometry '
        f'type="Geometry">{geom}</geometry>{bb(T)}{norm(L)}</GeometricSource>')
    if kind == "point":
        return ('<PointSource positionX="0 pc" positionY="0 pc" positionZ='
                f'"0 pc">{norm(g["L_disk"])}</PointSource>')
    if kind == "decorated":
        # a rotated disk combined with a clipped Plummer sphere
        geom = ('<CombineGeometryDecorator firstWeight="1" secondWeight='
                '"0.4"><firstGeometry type="Geometry">'
                '<RotateGeometryDecorator eulerAlpha="20 deg" eulerBeta='
                f'"50 deg" eulerGamma="-30 deg"><geometry type="Geometry">'
                f'{disk}</geometry></RotateGeometryDecorator></firstGeometry>'
                '<secondGeometry type="Geometry"><SphericalClipGeometry'
                f'Decorator remove="Inside" clipRadius="0.5 {unit}" centerX='
                f'"0 {unit}" centerY="0 {unit}" centerZ="0 {unit}"><geometry '
                'type="Geometry"><PlummerGeometry scaleLength='
                f'"1.5 {unit}"/></geometry></SphericalClipGeometryDecorator>'
                '</secondGeometry></CombineGeometryDecorator>')
        return src(geom, g["T_disk"], g["L_disk"])
    return (src(disk, g["T_disk"], g["L_disk"])
            + src(bulge, g["T_bulge"], g["bulge_frac"] * g["L_disk"]))


def galaxy_ski(directory, name: str, grid: str = "cylinder", nr: int = 128,
               nz: int = 128, level: int = 8, spiral: bool = False,
               sources: str = "galaxy", rf_bins: int = 8, npix: int = 128,
               nlam: int = 40, unit: str = "kpc", nphi: int = 64,
               sites: int = 100_000, relax: bool = False,
               emission: bool = False) -> str:
    """A ski file of disk_cyl's galaxy (GALAXY) written into directory
    beside the MRN mix file: ExtinctionOnly over 0.1-3 micron with an
    rf_bins-bin RF; grid "cylinder" (a Cylinder2DSpatialGrid, a PowMesh of
    nr radial and a SymPowMesh of nz z bins, both ratio 50), "tree" (a
    density octree over the same box, maxLevel level) or "cartesian" (a
    uniform nr^3 grid); the dust disk wrapped in a 2-arm spiral decorator
    with spiral; sources "galaxy" (disk and bulge), "point" (a central
    point source at 0.55 micron, OligoExtinctionOnly) or "decorated";
    instruments at inclinations 0 and 90 deg, npix^2 pixels, nlam log
    bins. unit "pc" shrinks every length of the model 1000-fold (the tests
    hold the port against the reference there: the reference's curvilinear
    steps overflow f32 past 0.6 kpc). Grid "sphere3d" is a
    Sphere3DSpatialGrid of nr radial (PowMesh, ratio 50), nz polar
    (SymPowMesh, ratio 20) and nphi azimuthal bins to R; "cylinder3d" a
    Cylinder3DSpatialGrid of nr radial (PowMesh), nphi azimuthal and nz z
    (SymPowMesh) bins; "tetra" and "voronoi" a TetraMeshSpatialGrid or
    VoronoiMeshSpatialGrid of `sites` DustDensity sites over the box,
    Lloyd-relaxed with relax. With emission the mode is DustEmission
    (equilibrium emission over 1-2000 micron, the RF over the sources'
    range)."""
    import shutil
    g = GALAXY
    R, Z = g["r_max"], g["z_max"]
    dust = (f'<ExpDiskGeometry scaleLength="{g["dust_h_r"]} {unit}" '
            f'scaleHeight="{g["dust_h_z"]} {unit}"/>')
    if spiral:
        dust = ('<SpiralStructureGeometryDecorator numArms="2" pitchAngle='
                f'"18 deg" radiusZeroPoint="{g["dust_h_r"]} {unit}" '
                'phaseZeroPoint="0 deg" perturbationWeight="0.5" index="1">'
                f'<geometry type="Geometry">{dust}</geometry>'
                '</SpiralStructureGeometryDecorator>')
    box = (f'minX="-{R} {unit}" maxX="{R} {unit}" minY="-{R} {unit}" '
           f'maxY="{R} {unit}" minZ="-{Z} {unit}" maxZ="{Z} {unit}"')
    if grid == "cylinder":
        grid_xml = (f'<Cylinder2DSpatialGrid maxRadius="{R} {unit}" minZ='
                    f'"-{Z} {unit}" maxZ="{Z} {unit}"><meshRadial type="Mesh">'
                    f'<PowMesh numBins="{nr}" ratio="50"/></meshRadial>'
                    f'<meshZ type="Mesh"><SymPowMesh numBins="{nz}" '
                    'ratio="50"/></meshZ></Cylinder2DSpatialGrid>')
    elif grid == "tree":
        grid_xml = (f'<PolicyTreeSpatialGrid {box} treeType="OctTree">'
                    '<policy type="TreePolicy"><DensityTreePolicy minLevel='
                    f'"2" maxLevel="{level}" maxDustFraction="1e-4"/>'
                    '</policy></PolicyTreeSpatialGrid>')
    elif grid == "sphere3d":
        grid_xml = (f'<Sphere3DSpatialGrid maxRadius="{R} {unit}">'
                    '<meshRadial type="Mesh"><PowMesh numBins='
                    f'"{nr}" ratio="50"/></meshRadial><meshPolar type="Mesh">'
                    f'<SymPowMesh numBins="{nz}" ratio="20"/></meshPolar>'
                    f'<meshAzimuthal type="Mesh"><LinMesh numBins="{nphi}"/>'
                    '</meshAzimuthal></Sphere3DSpatialGrid>')
    elif grid == "cylinder3d":
        grid_xml = (f'<Cylinder3DSpatialGrid maxRadius="{R} {unit}" minZ='
                    f'"-{Z} {unit}" maxZ="{Z} {unit}"><meshRadial type="Mesh">'
                    f'<PowMesh numBins="{nr}" ratio="50"/></meshRadial>'
                    f'<meshAzimuthal type="Mesh"><LinMesh numBins="{nphi}"/>'
                    '</meshAzimuthal><meshZ type="Mesh"><SymPowMesh numBins='
                    f'"{nz}" ratio="50"/></meshZ></Cylinder3DSpatialGrid>')
    elif grid in ("tetra", "voronoi"):
        tag = "TetraMeshSpatialGrid" if grid == "tetra" else \
            "VoronoiMeshSpatialGrid"
        grid_xml = (f'<{tag} {box} policy="DustDensity" numSites="{sites}" '
                    f'relaxSites="{str(relax).lower()}"/>')
    else:
        mesh = lambda ax: (f'<mesh{ax} type="Mesh"><LinMesh numBins="{nr}"/>'
                           f'</mesh{ax}>')
        grid_xml = (f'<CartesianSpatialGrid {box}>{mesh("X")}{mesh("Y")}'
                    f'{mesh("Z")}</CartesianSpatialGrid>')
    oligo = sources == "point"
    lo, hi = g["lam"]
    src_sys = ('<SourceSystem wavelengths="0.55 micron" sourceBias="0.5">'
               if oligo else f'<SourceSystem minWavelength="{lo} micron" '
               f'maxWavelength="{hi} micron" sourceBias="0.5">')
    rf = ('' if oligo else
          '<radiationFieldOptions type="RadiationFieldOptions">'
          '<RadiationFieldOptions storeRadiationField="true">'
          '<radiationFieldWLG type="DisjointWavelengthGrid">'
          f'<LogWavelengthGrid minWavelength="{lo} micron" maxWavelength='
          f'"{hi} micron" numWavelengths="{rf_bins}"/></radiationFieldWLG>'
          '</RadiationFieldOptions></radiationFieldOptions>')
    if emission:
        rf += ('<dustEmissionOptions type="DustEmissionOptions">'
               '<DustEmissionOptions dustEmissionType="Equilibrium" '
               'includeHeatingByCMB="false" maxFractionOfPrimary="0.01" '
               'maxFractionOfPrevious="0.03" sourceWeight="1" '
               'wavelengthBias="0.5"><cellLibrary type="SpatialCellLibrary">'
               '<AllCellsLibrary/></cellLibrary><dustEmissionWLG type='
               '"DisjointWavelengthGrid"><LogWavelengthGrid minWavelength='
               '"1 micron" maxWavelength="2000 micron" numWavelengths="40"/>'
               '</dustEmissionWLG></DustEmissionOptions>'
               '</dustEmissionOptions>')
    wlg = ('' if oligo else '<defaultWavelengthGrid type="WavelengthGrid">'
           f'<LogWavelengthGrid minWavelength="{lo} micron" maxWavelength='
           f'"{hi} micron" numWavelengths="{nlam}"/></defaultWavelengthGrid>')
    fov = 2.2 * R
    inst = lambda name, inc: (
        f'<FullInstrument instrumentName="{name}" distance='
        f'"{g["distance_mpc"]} Mpc" inclination="{inc} deg" azimuth="0 deg" '
        f'roll="0 deg" fieldOfViewX="{fov} {unit}" numPixelsX="{npix}" '
        f'centerX="0 pc" fieldOfViewY="{fov} {unit}" numPixelsY="{npix}" '
        'centerY="0 pc" recordComponents="true" numScatteringLevels="0" '
        'recordPolarization="false" recordStatistics="true"/>')
    mode = "OligoExtinctionOnly" if oligo else (
        "DustEmission" if emission else "ExtinctionOnly")
    text = f"""<?xml version='1.0' encoding='UTF-8'?>
<skirt-simulation-hierarchy type="MonteCarloSimulation" format="9" producer="chip_smoke">
  <MonteCarloSimulation userLevel="Expert" simulationMode="{mode}" numPackets="{N_GEO}">
    <random type="Random"><Random seed="0"/></random>
    <units type="Units"><ExtragalacticUnits fluxOutputStyle="Wavelength"/></units>
    <cosmology type="Cosmology"><LocalUniverseCosmology/></cosmology>
    <sourceSystem type="SourceSystem">{src_sys}<sources type="Source">{_disk_sources(sources, unit)}</sources></SourceSystem></sourceSystem>
    <mediumSystem type="MediumSystem"><MediumSystem>
      <photonPacketOptions type="PhotonPacketOptions"><PhotonPacketOptions forceScattering="true" minWeightReduction="1e4" minScattEvents="0" pathLengthBias="0.5"/></photonPacketOptions>
      {rf}
      <media type="Medium"><GeometricMedium velocityMagnitude="0 km/s">
        <geometry type="Geometry">{dust}</geometry>
        <materialMix type="MaterialMix"><MeanFileDustMix filename="mrn_mean.txt"/></materialMix>
        <normalization type="MaterialNormalization"><NumberMaterialNormalization number="{dust_disk_number(unit):.9e}"/></normalization>
      </GeometricMedium></media>
      <grid type="SpatialGrid">{grid_xml}</grid>
    </MediumSystem></mediumSystem>
    <instrumentSystem type="InstrumentSystem"><InstrumentSystem>{wlg}<instruments type="Instrument">{inst("i0", 0)}{inst("i90", 90)}</instruments></InstrumentSystem></instrumentSystem>
  </MonteCarloSimulation>
</skirt-simulation-hierarchy>
"""
    path = os.path.join(str(directory), f"{name}.ski")
    with open(path, "w") as f:
        f.write(text)
    shutil.copy(os.path.join(GOLDEN, "mrn_mean.txt"), str(directory))
    return path


# the Ivezic et al. (1997) setup of tests/test_sphere_grid.py:48-88 on the
# 1D sphere: a central point source at 0.55 micron in an r^-1.5 MRN shell
# from 0.1 to 1 pc of tau_V = 1 through the whole z axis
IVEZIC = dict(r_in=0.1, r_out=1.0, p=1.5, r_grid=1.05, L=1e5)


def ivezic_ski(directory, name: str = "ivezic_sphere1d", nr: int = 60,
               mesh: str = "PowMesh", dust: bool = False, nlam: int = 25,
               npix: int = 64) -> str:
    """The Ivezic setup as a ski file (OligoExtinctionOnly at 0.55 micron,
    a Sphere1DSpatialGrid of nr shells on a radial `mesh` of ratio 20 to
    1.05 pc, one FullInstrument face-on at 1 kpc). dust: a DustEmission run
    instead, bench2's: a 20,000 K blackbody, 0.09-100 micron, an RF of
    nlam bins, equilibrium emission on nlam bins of 1-2000 micron, the
    instrument on 2 * nlam bins of 0.09-1000 micron, and the temperature
    and radiation-field probes."""
    import shutil
    v = IVEZIC
    if dust:
        mode, waves = "DustEmission", (
            'minWavelength="0.09 micron" maxWavelength="100 micron"')
        sed = '<sed type="SED"><BlackBodySED temperature="20000 K"/></sed>'
        log = lambda lo, hi, n: (f'<LogWavelengthGrid minWavelength="{lo} '
                                 f'micron" maxWavelength="{hi} micron" '
                                 f'numWavelengths="{n}"/>')
        options = f"""
      <radiationFieldOptions type="RadiationFieldOptions"><RadiationFieldOptions storeRadiationField="true"><radiationFieldWLG type="DisjointWavelengthGrid">{log(0.09, 100, nlam)}</radiationFieldWLG></RadiationFieldOptions></radiationFieldOptions>
      <dustEmissionOptions type="DustEmissionOptions"><DustEmissionOptions dustEmissionType="Equilibrium" includeHeatingByCMB="false" maxFractionOfPrimary="0.01" maxFractionOfPrevious="0.03" sourceWeight="1" wavelengthBias="0.5"><cellLibrary type="SpatialCellLibrary"><AllCellsLibrary/></cellLibrary><dustEmissionWLG type="DisjointWavelengthGrid">{log(1, 2000, nlam)}</dustEmissionWLG></DustEmissionOptions></dustEmissionOptions>"""
        default_wlg = (f'<defaultWavelengthGrid type="WavelengthGrid">'
                       f'{log(0.09, 1000, 2 * nlam)}</defaultWavelengthGrid>')
        probes = """<probes type="Probe">
      <RadiationFieldProbe probeName="rf" writeWavelengthGrid="true" probeAfter="Run"><form type="Form"><PerCellForm/></form></RadiationFieldProbe>
      <TemperatureProbe probeName="T" aggregation="Type" probeAfter="Run"><form type="Form"><PerCellForm/></form></TemperatureProbe>
    </probes>"""
    else:
        mode, waves, sed, options = ("OligoExtinctionOnly",
                                     'wavelengths="0.55 micron"', "", "")
        default_wlg = probes = ""
    text = f"""<?xml version='1.0' encoding='UTF-8'?>
<skirt-simulation-hierarchy type="MonteCarloSimulation" format="9" producer="chip_smoke">
  <MonteCarloSimulation userLevel="Expert" simulationMode="{mode}" numPackets="{N_GEO}">
    <random type="Random"><Random seed="0"/></random>
    <units type="Units"><ExtragalacticUnits fluxOutputStyle="Wavelength"/></units>
    <cosmology type="Cosmology"><LocalUniverseCosmology/></cosmology>
    <sourceSystem type="SourceSystem"><SourceSystem {waves} sourceBias="0.5"><sources type="Source">
      <PointSource positionX="0 pc" positionY="0 pc" positionZ="0 pc">{sed}<normalization type="LuminosityNormalization"><IntegratedLuminosityNormalization wavelengthRange="Source" integratedLuminosity="{v['L']} Lsun"/></normalization></PointSource>
    </sources></SourceSystem></sourceSystem>
    <mediumSystem type="MediumSystem"><MediumSystem>
      <photonPacketOptions type="PhotonPacketOptions"><PhotonPacketOptions forceScattering="true" minWeightReduction="1e4" minScattEvents="0" pathLengthBias="0.5"/></photonPacketOptions>{options}
      <media type="Medium"><GeometricMedium velocityMagnitude="0 km/s">
        <geometry type="Geometry"><ShellGeometry minRadius="{v['r_in']} pc" maxRadius="{v['r_out']} pc" exponent="{v['p']}"/></geometry>
        <materialMix type="MaterialMix"><MeanFileDustMix filename="mrn_mean.txt"/></materialMix>
        <normalization type="MaterialNormalization"><OpticalDepthMaterialNormalization axis="Z" wavelength="0.55 micron" opticalDepth="1"/></normalization>
      </GeometricMedium></media>
      <grid type="SpatialGrid"><Sphere1DSpatialGrid maxRadius="{v['r_grid']} pc"><meshRadial type="Mesh"><{mesh} numBins="{nr}" ratio="20"/></meshRadial></Sphere1DSpatialGrid></grid>
    </MediumSystem></mediumSystem>
    <instrumentSystem type="InstrumentSystem"><InstrumentSystem>{default_wlg}<instruments type="Instrument">
      <FullInstrument instrumentName="i0" distance="1 kpc" inclination="0 deg" azimuth="0 deg" roll="0 deg" fieldOfViewX="2.2 pc" numPixelsX="{npix}" centerX="0 pc" fieldOfViewY="2.2 pc" numPixelsY="{npix}" centerY="0 pc" recordComponents="true" numScatteringLevels="0" recordPolarization="false" recordStatistics="true"/>
    </instruments></InstrumentSystem></instrumentSystem>
    <probeSystem type="ProbeSystem"><ProbeSystem>{probes}</ProbeSystem></probeSystem>
  </MonteCarloSimulation>
</skirt-simulation-hierarchy>
"""
    path = os.path.join(str(directory), f"{name}.ski")
    with open(path, "w") as f:
        f.write(text)
    shutil.copy(os.path.join(GOLDEN, "mrn_mean.txt"), str(directory))
    return path


# the generated configurations of MARCH_SMALL and the full-width phases:
# name -> (the function that writes its ski file, its arguments)
GEOMETRIC = {
    "disk_cyl": (galaxy_ski, {}),
    "disk_tree": (galaxy_ski, dict(grid="tree", spiral=True)),
    "disk_cyl_small": (galaxy_ski, dict(nr=16, nz=16, npix=32, nlam=12,
                                        rf_bins=4)),
    "ivezic_sphere1d": (ivezic_ski, dict(nr=40)),
    # DustEmission on the 1D sphere: its shells launch in their bounding
    # cubes (full width, and reduced for the draw-for-draw test)
    "ivezic_dust": (ivezic_ski, dict(nr=40, dust=True)),
    "ivezic_dust_small": (ivezic_ski, dict(nr=12, dust=True, nlam=8,
                                           npix=16)),
    "geometric_cartesian": (galaxy_ski, dict(grid="cartesian", nr=16,
                                             npix=32, nlam=12, rf_bins=4)),
    "disk_tree_small": (galaxy_ski, dict(grid="tree", level=4, spiral=True,
                                         npix=32, nlam=12, rf_bins=4)),
    "decorated_cyl": (galaxy_ski, dict(nr=16, nz=16, npix=32, nlam=12,
                                       rf_bins=4, sources="decorated")),
    "disk_cyl_point": (galaxy_ski, dict(sources="point")),
}


def geometric_ski(name: str, directory, **over) -> str:
    """The ski file of GEOMETRIC[name] (its arguments updated by over),
    written into directory."""
    write, kw = GEOMETRIC[name]
    return write(directory, name, **dict(kw, **over))



GEO_CASES = ("disk_cyl_small", "ivezic_sphere1d", "geometric_cartesian",
             "disk_tree_small", "decorated_cyl")


def geometric_config(name: str, device, directory, **run):
    """GEOMETRIC[name] through the port's load_ski at full width (N_GEO
    packets in batches of B_GEO, 24 events) unless run says otherwise."""
    from skirt9_tpu_torch.config.ski import load_ski
    return load_ski(geometric_ski(name, directory), device=device,
                    **dict(dict(num_packets=N_GEO, batch_size=B_GEO,
                                max_events=24), **run))


def phase_kernels_march_curvi(torch) -> dict:
    """The march kernel's curvilinear modes against their plain versions,
    bit for bit (_march_check): march_cylinder2d at disk_cyl's first event
    (2^16 lanes of its disk, the 128 x 128 cylinder to 25 kpc, shift 10,
    S = 256) and march_sphere1d at the Ivezic setup's (40 shells); both
    also on seeded rays from inside and outside a linear-mesh grid."""
    from skirt9_tpu_torch.grids.cylinder import make_cylinder2d
    from skirt9_tpu_torch.grids.sphere import make_sphere1d
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, mode in (("disk_cyl", "march_cylinder2d"),
                           ("ivezic_sphere1d", "march_sphere1d")):
            sim = geometric_config(name, "cuda", tmp, **(
                dict(num_packets=B_GEO) if name.startswith("ivezic") else {}))
            S = sim.options.max_steps
            pos, dirn, cell, alive = _first_event_lanes(torch, sim, B_GEO)
            out[mode] = dict(_march_check(torch, mode, sim.grid, pos, dirn,
                                          cell, S, alive),
                             cells=sim.grid.ncells, shift=sim.grid.shift)
            del sim
    rs = np.random.default_rng(31)
    dev = torch.device("cuda")
    for mode, grid in (
            ("march_sphere1d", make_sphere1d(PC, 100)),
            ("march_cylinder2d", make_cylinder2d(PC, -0.5 * PC, 0.5 * PC,
                                                 100, 60))):
        grid = grid.to(dev)
        pos = rs.uniform(-1.5 * PC, 1.5 * PC, (B_GEO, 3))
        d = rs.normal(size=(B_GEO, 3))
        t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
        pos, d = t32(pos), t32(d / np.linalg.norm(d, axis=1, keepdims=True))
        pos, cell, _ = grid.move_inside(pos, d)
        out[f"{mode}_linear"] = _march_check(
            torch, mode, grid, pos, d, cell, min(grid.max_steps(), 256),
            cell >= 0)
    torch.cuda.empty_cache()
    emit({"phase": "kernels_march_curvi", **out})
    return out


def blackbody_mix_gates(sim, sed_um, n_sigma: float = 5.0) -> dict:
    """The transparent SED [W/m2/micron] of GeometricSources with blackbody
    SEDs over 0.1-3 micron, bin by bin, against the sum of each source's
    L / (4 pi d^2) times its blackbody's share of the bin over the bin's
    width, within n_sigma of the run's sampling noise there (each source's
    packets by the simulation's source allocation, the wavelength bias's
    per-packet variance int_bin p^2 / q - P^2), and its integral within
    n_sigma of its noise."""
    h, c, kB = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    lo, hi = (x * 1e-6 for x in GALAXY["lam"])
    x = np.geomspace(lo, hi, 400_001)
    borders = np.asarray(sim.instruments[0].wave_borders, np.float64)
    cum = lambda f: np.concatenate([[0.0], np.cumsum(
        0.5 * (f[1:] + f[:-1]) * np.diff(x))])
    at = lambda f: np.diff(np.interp(np.clip(borders, lo, hi), x, cum(f)))
    counts = sim._source_allocation(sim.num_packets)
    d = GALAXY["distance_mpc"] * 1e6 * 3.08567758149e16
    want, var = 0.0, 0.0
    L_tot = 0.0
    # the galaxy's sources in order: the disk's blackbody, the bulge's
    for src, n, T in zip(sim.sources, counts,
                         (GALAXY["T_disk"], GALAXY["T_bulge"])):
        p = x ** -5 / np.expm1(h * c / (x * kB * T))
        p /= np.trapezoid(p, x)
        xi = src.wavelength_bias
        q = (1 - xi) * p + xi / (x * np.log(hi / lo))
        P, Q = at(p), at(p * p / q)
        flux = src.luminosity / (4 * np.pi * d ** 2)
        want = want + flux * P
        var = var + flux ** 2 * np.maximum(Q - P * P, 0.0) / n
        L_tot += flux
    width = np.diff(borders) * 1e6
    lit = want > 0
    ratio = sed_um["transparent"][lit] * width[lit] / want[lit]
    sigma = np.sqrt(var[lit]) / want[lit]
    z = np.abs(ratio - 1) / sigma
    require(float(z.max()) <= n_sigma, f"transparent SED within {n_sigma} "
            f"sigma of the two blackbodies in every bin ({float(z.max())})")
    total = float((sed_um["transparent"] * width).sum() / L_tot)
    sigma_tot = math.sqrt(float(var.sum())) / L_tot
    require(abs(total - 1) <= n_sigma * sigma_tot,
            f"transparent SED's integral {total} within {n_sigma} sigma "
            f"({sigma_tot}) of the sources' L / (4 pi d^2)")
    return dict(transparent_max_sigmas=float(z.max()),
                transparent_max_rel_err=float(np.abs(ratio - 1).max()),
                transparent_integral=total,
                transparent_integral_sigma=sigma_tot)


def cell_masses(grid, geometry) -> np.ndarray:
    """The mass of a unit-mass axisymmetric geometry in each cell of a 2D
    cylinder: 8 x 8 Gauss-Legendre nodes per cell in (R, z) of its
    density_np on the x-z plane times 2 pi R, in f64 on the host."""
    g, w = np.polynomial.legendre.leggauss(8)
    rb = grid.rb.double().cpu().numpy()
    zb = grid.zb.double().cpu().numpy()
    R = 0.5 * (rb[1:, None] + rb[:-1, None]) + 0.5 * np.diff(rb)[:, None] * g
    Z = 0.5 * (zb[1:, None] + zb[:-1, None]) + 0.5 * np.diff(zb)[:, None] * g
    wr = 0.5 * np.diff(rb)[:, None] * w * 2 * np.pi * R     # (nr, 8)
    wz = 0.5 * np.diff(zb)[:, None] * w                     # (nz, 8)
    nr, nz = len(rb) - 1, len(zb) - 1
    out = np.zeros((nr, nz))
    for a in range(8):
        pos = np.zeros((nr, nz, 8, 3))
        pos[..., 0] = R[:, None, a, None]
        pos[..., 2] = Z[None, :, :]
        rho = geometry.density_np(pos.reshape(-1, 3)).reshape(nr, nz, 8)
        out += wr[:, None, a] * (rho * wz[None, :, :]).sum(axis=-1)
    return out.reshape(-1)


def sampling_gates(torch, sim, n: int = 1 << 22,
                   n_sigma: float = 5.0) -> dict:
    """2^22 positions from each source's geometry (its `sample` on the
    card, in batches of 2^20) binned into the 2D cylinder's cells against
    the geometry's cell masses (cell_masses) and the mass outside the grid
    as one more bin: chi-square over the bins expecting at least 5 within
    n_sigma of its degrees of freedom."""
    from skirt9_tpu_torch.ops import rng
    out = {}
    for k, src in enumerate(sim.sources):
        counts = torch.zeros(sim.grid.ncells + 1, dtype=torch.float64,
                             device=sim.device)
        for b in range(n // (1 << 20)):
            hist = torch.arange(b << 20, (b + 1) << 20, device=sim.device)
            keys = rng.event_keys(rng.history_keys(rng.seed_key(
                97 + k, sim.device), hist), rng.LAUNCH_EVENT)
            cell = sim.grid.locate(src.geometry.sample(keys))
            counts += torch.bincount(torch.where(cell < 0, sim.grid.ncells,
                                                 cell),
                                     minlength=sim.grid.ncells + 1).double()
        m = cell_masses(sim.grid, src.geometry)
        exp = n * np.concatenate([m, [max(1.0 - m.sum(), 0.0)]])
        obs = counts.cpu().numpy()
        use = exp >= 5
        chi2 = float((((obs - exp) ** 2 / np.maximum(exp, 1e-300))[use]).sum())
        dof = int(use.sum()) - 1
        z = (chi2 - dof) / math.sqrt(2 * dof)
        require(z <= n_sigma, f"source {k}'s positions chi-square {chi2} "
                f"on {dof} dof: {z} sigma <= {n_sigma}")
        out[f"source{k}"] = dict(chi2=chi2, dof=dof, sigmas=z,
                                 outside_obs=float(obs[-1]),
                                 outside_exp=float(exp[-1]))
    return out


def column_tau(sim, lam: float = 0.55e-6, inst: int = 0) -> float:
    """The optical depth from the centre along +z through the 2D cylinder's
    innermost annulus, or from the centre outward through the 1D sphere's
    shells, in f64 on the host from the cells' extents and densities; on
    the polar grids and the tetrahedral mesh toward instrument inst
    (walk_tau)."""
    import torch
    if type(sim.grid).__name__ in ("Sphere2DGrid", "Sphere3DGrid",
                                   "Cylinder3DGrid", "TetraGrid"):
        return walk_tau(sim, lam, inst)
    from skirt9_tpu_torch.media import system as msys
    sig = msys.optics_at(sim.medium, torch.tensor(
        [lam], dtype=torch.float32, device=sim.device)).sigma_ext
    kappa = (sim.medium.nd.double() @ sig.double()[0]).cpu().numpy()
    if type(sim.grid).__name__ == "Sphere1DGrid":
        return float((np.diff(sim.grid.rb.double().cpu().numpy())
                      * kappa).sum())
    zb = sim.grid.zb.double().cpu().numpy()
    nz = len(zb) - 1
    up = zb[:-1] >= 0.0
    return float((np.diff(zb)[up] * kappa[:nz][up]).sum())


def march_tau(sim, lam: float = 0.55e-6, inst: int = 0) -> tuple:
    """(tau, reach): the optical depth at lam from the simulation's point
    source toward instrument inst summed in f64 on the host over the
    grid's own step, walked by the plain march (`march_geometry_plain`,
    torch operations, independent of the march kernel), and the share of
    the ray's length to the grid's edge that walk covers. The clumpy
    sphere's step, the reference's bit for bit, locates its structured
    cell at the moved position, which can round into the shell behind; the
    next step is then 0 and the lane stalls (ROADMAP.md queue C), on rays
    from the centre and at times on oblique ones."""
    import torch
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.transport import march as mr
    k = sim._inst_tabs[inst]["kobs"].reshape(1, 3).float().contiguous()
    pos = torch.tensor([sim.sources[0].position], dtype=torch.float32,
                       device=k.device)
    cell = sim.grid.locate(pos)
    cells, ds = mr.march_geometry_plain(sim.grid, pos, k, cell,
                                        sim.options.max_steps, cell >= 0)
    sig = msys.optics_at(sim.medium, torch.tensor(
        [lam], dtype=torch.float32, device=sim.device)).sigma_ext
    kappa = sim.medium.nd.double() @ sig.double()[0]
    ds = ds[:, 0].double()
    tau = float((ds * kappa[cells[:, 0].long()]).sum())
    p0 = np.asarray(sim.sources[0].position, np.float64)
    kd = k[0].double().cpu().numpy()
    pk, R = float(p0 @ kd), float(sim.grid.sph.rb[-1])
    length = -pk + math.sqrt(pk * pk - (float(p0 @ p0) - R * R))
    return tau, float(ds.sum()) / length


def direct_gate(torch, sim, what: str, inst: int = 0) -> dict:
    """A point source's run: direct over transparent SED (one bin, at 0.55
    micron) of instrument inst (face-on by default) equal to exp(-tau) of
    column_tau within 1e-3; on the clumpy sphere (an off-centre source)
    every instrument's by clumpy_direct, one of them at least on the
    cells' geometry."""
    (rf, accs), launches = drive(
        (MODES_OF[type(sim.grid).__name__],) + DETECT, SWEEPS,
        lambda: sim.run_primary(verbose=False))
    from skirt9_tpu_torch.instruments import distant as dinst
    sed = accs[inst]["sed"].double().cpu()
    att = float(sed[dinst.KIND_PRIMARY_DIRECT].sum() / sed[
        dinst.KIND_TRANSPARENT].sum())
    res = {"packets": sim.num_packets, "launch_counts": launches,
           "packets_per_s": sim.last_rate}
    if type(sim.grid).__name__ == "ClumpySphericalGrid":
        res.update(source_pc=[v / PC for v in sim.sources[0].position],
                   instruments=[clumpy_direct(sim, accs, what, i)
                                for i in range(len(accs))])
        require(any(r["reach"] >= 1 - 1e-6 for r in res["instruments"]),
                f"{what}: a ray reaches the edge, gated on the geometry")
        return res
    tau = column_tau(sim, inst=inst)
    e = abs(att / math.exp(-tau) - 1)
    require(e <= 1e-3, f"{what}: direct / transparent {att} against "
            f"exp(-{tau}) within 1e-3 ({e})")
    res.update(tau=tau, direct_over_transparent=att, rel_err=e)
    return res


def clumpy_direct(sim, accs, what: str, inst: int) -> dict:
    """The clumpy sphere's direct light toward instrument inst (direct over
    transparent SED at 0.55 micron) equal to exp(-tau) of the step's plain
    march (march_tau) within 1e-3, and, where that march reaches the
    grid's edge, to exp(-tau) of the cells' geometry (walk_tau) too; a ray
    that stalls (ROADMAP.md queue C) is reported with its reach."""
    from skirt9_tpu_torch.instruments import distant as dinst
    sed = accs[inst]["sed"].double().cpu()
    att = float(sed[dinst.KIND_PRIMARY_DIRECT].sum() / sed[
        dinst.KIND_TRANSPARENT].sum())
    tau_m, reach = march_tau(sim, inst=inst)
    tau_w = walk_tau(sim, inst=inst)
    e_m = abs(att / math.exp(-tau_m) - 1)
    require(e_m <= 1e-3, f"{what} {inst}: direct / transparent {att} "
            f"against the plain march's exp(-{tau_m}) within 1e-3 ({e_m})")
    e_w = abs(att / math.exp(-tau_w) - 1)
    require(reach < 1 - 1e-6 or e_w <= 1e-3, f"{what} {inst}: direct / "
            f"transparent {att} against exp(-{tau_w}) within 1e-3 ({e_w})")
    return {"inst": inst, "direct_over_transparent": att, "march_tau": tau_m,
            "march_rel_err": e_m, "reach": reach, "geometric_tau": tau_w,
            "geometric_rel_err": e_w}


MODES_OF = {"Sphere1DGrid": "march_sphere1d",
            "Cylinder2DGrid": "march_cylinder2d"}


def phase_full_width_geometric(torch, smi: str, name: str) -> dict:
    """disk_cyl (the galaxy's two geometric sources on the 128 x 128
    cylinder march) or disk_tree (on a density octree of maxLevel 8 with a
    spiral dust disk, the tree sweep: kernels 4-5) at N_GEO packets in
    batches of B_GEO, 24 events, after a one-batch warm-up: its kernels and
    detect launched, no other; gated: the transparent SED against the two
    blackbodies (blackbody_mix_gates), R < 0.01 in the bins above 1% of
    the peak; for
    disk_cyl also 2^22 positions of each source against its cell masses
    (sampling_gates), and the face-on direct light of a central point
    source in the disk (disk_cyl_point, 2^18 packets) and of the Ivezic
    shell on the 1D sphere (2^18) against exp(-tau) (direct_gate); one
    batch profiled (host_per_event)."""
    cyl = name == "disk_cyl"
    must = ("march_cylinder2d",) if cyl else ML
    with tempfile.TemporaryDirectory() as tmp:
        sim = geometric_config(name, "cuda", tmp)
        one_batch(sim, sim.run_primary)            # warm-up
        t0 = time.perf_counter()
        (rf, accs), launches = drive(
            must + DETECT, tuple(k for k in SWEEPS + MARCH + MARCH_TREE
                                 + MARCH_CURVI if k not in must),
            lambda: sim.run_primary(verbose=False))
        dt = time.perf_counter() - t0
        stats = dict(sim.last_stats)
        paths = [p for p in sim.write_outputs(accs, name, tmp)
                 if p.endswith("_sed.dat")]
        cols = np.loadtxt(paths[0])
        cols90 = np.loadtxt(paths[1])
        gates = blackbody_mix_gates(sim, {"transparent": cols[:, 2]})
        lit = cols[:, 1] > 1e-2 * cols[:, 1].max()
        R = cols[lit, 7]
        require(float(R.max()) < 0.01, f"SED relative error R {R.max()}")
        gates["R_max"] = float(R.max())
        res = {"phase": f"full_width_{name}", "cells": sim.grid.ncells,
               "max_steps": sim.options.max_steps, "packets": sim.num_packets,
               "batch": sim.batch_size, "packets_per_s": sim.num_packets / dt,
               "seconds": dt, "events": stats["events"],
               "rf_bins": rf.shape[1],
               "launches": {k: v for k, v in launches.items() if v}, **gates,
               "direct_over_transparent_i0": float(
                   cols[lit, 3].sum() / cols[lit, 2].sum()),
               "direct_over_transparent_i90": float(
                   cols90[lit, 3].sum() / cols90[lit, 2].sum())}
        if cyl:
            res["shift"] = sim.grid.shift
            res["sampling"] = sampling_gates(torch, sim)
            res["point_source"] = direct_gate(torch, geometric_config(
                "disk_cyl_point", "cuda", tmp, num_packets=1 << 18),
                "disk_cyl_point")
            res["ivezic"] = direct_gate(torch, geometric_config(
                "ivezic_sphere1d", "cuda", tmp, num_packets=1 << 18),
                "ivezic_sphere1d")
        else:
            res["leaves"] = sim.grid.ncells
        n_full, sim.num_packets = sim.num_packets, B_GEO
        res["breakdown"] = host_per_event(
            torch, sim, lambda s: s.run_primary(verbose=False), warm=True)
        sim.num_packets = n_full
        del sim
    torch.cuda.empty_cache()
    emit(dict(res, device=torch.cuda.get_device_name(0), nvidia_smi=smi))
    return launches, res["ivezic"]["launch_counts"] if cyl else None


# ------------------------------------------------------ imported snapshots
# GALAXY's dust disk as hydro snapshots: a clumpy exponential disk (SNAP's
# clumps: Gaussian blobs drawn from the disk, a share of its mass) on an
# adaptive mesh written as a RAMSES-style Morton '!' file (its leaves' gas
# density, metallicity and temperature; its star-forming leaves, in a second
# file of the same tree, an AdaptiveMeshSource with bench4's SSP family),
# and as SPH particles (gas particles of the dust disk, star particles of
# the stellar disk).
SNAP = dict(n_clumps=300, clump_frac=0.3, clump_sigma=0.15, seed=31,
            z_scale=10.0, m_stars=1e9, sf_share=0.02, n_gas=100_000,
            n_stars=20_000, h_stars=0.1, ngb=32)
MSUN_AMR, PC_AMR = 1.98892e30, 3.0857e16   # the loader's AMR units
MU_MRN = 1.5e-29                           # MeanFileDustMix's mass per entity


def _disk_points(rs, n: int, h_r: float, h_z: float) -> np.ndarray:
    """n positions [kpc] of an exponential disk: R ~ Gamma(2, h_r), z ~
    Laplace(h_z)."""
    R = rs.gamma(2.0, h_r, n)
    phi = rs.uniform(0.0, 2 * np.pi, n)
    return np.stack([R * np.cos(phi), R * np.sin(phi),
                     rs.laplace(0.0, h_z, n)], axis=-1)


def clumpy_disk(pts: np.ndarray) -> np.ndarray:
    """The unit-mass density [1/kpc^3] of the clumpy dust disk at pts
    [kpc]: (1 - f) of GALAXY's exponential dust disk and f in SNAP's
    Gaussian clumps."""
    g, s = GALAXY, SNAP
    h_r, h_z = g["dust_h_r"], g["dust_h_z"]
    R = np.hypot(pts[:, 0], pts[:, 1])
    disk = np.exp(-R / h_r - np.abs(pts[:, 2]) / h_z) \
        / (4 * np.pi * h_r ** 2 * h_z)
    from scipy.spatial import cKDTree
    centers = _disk_points(np.random.default_rng(s["seed"]), s["n_clumps"],
                           h_r, h_z)
    sig = s["clump_sigma"]
    # the clumps within 6 sigma of each point (the rest adds < 1e-7)
    pairs = cKDTree(pts).sparse_distance_matrix(
        cKDTree(centers), 6 * sig, output_type="ndarray")
    clump = np.bincount(pairs["i"], np.exp(-0.5 * (pairs["v"] / sig) ** 2),
                        minlength=len(pts))
    clump /= (2 * np.pi) ** 1.5 * sig ** 3 * s["n_clumps"]
    return (1 - s["clump_frac"]) * disk + s["clump_frac"] * clump


def amr_mesh(root=(2, 2, 2), level: int = 8, threshold: float = 3e-5):
    """The adaptive mesh of the clumpy dust disk in GALAXY's box [kpc]: the
    root divided by `root`, then each cell halved along every axis while
    its mass (the mean density at its 8 sub-cell midpoints times its
    volume) exceeds `threshold` of the unit total, `level` levels of cells
    in all. Returns (Morton node list: ('!', div) or ('leaf', i), leaf
    boxes lo, hi (N, 3) [kpc] in f64, leaf masses (N,))."""
    g = GALAXY
    lo0 = np.array([-g["r_max"], -g["r_max"], -g["z_max"]])
    hi0 = -lo0
    mid = (np.stack(np.meshgrid(*[[0.25, 0.75]] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3))

    def mass(lo, size):
        size = np.broadcast_to(size, lo.shape)
        pts = (lo[:, None, :] + mid[None] * size[:, None, :]).reshape(-1, 3)
        return clumpy_disk(pts).reshape(-1, 8).mean(1) \
            * np.prod(size, axis=-1)

    def children(lo, size, div):
        div = np.asarray(div)
        sub = size / div
        ijk = np.stack(np.meshgrid(*[np.arange(n) for n in div[::-1]],
                                   indexing="ij"), axis=-1).reshape(-1, 3)
        ijk = ijk[:, ::-1]                       # x fastest
        return (lo[:, None, :] + ijk[None] * sub).reshape(-1, 3), sub

    # per level: the cells' corners, their size, which of them refine
    los, sizes, refine = [], [], []
    lo, size = children(lo0[None], hi0 - lo0, root)
    for lev in range(1, level + 1):
        ref = (mass(lo, size) > threshold) if lev < level \
            else np.zeros(len(lo), bool)
        los.append(lo)
        sizes.append(size)
        refine.append(ref)
        if not ref.any():
            break
        lo, size = children(lo[ref], size, (2, 2, 2))
    first = [np.cumsum(r) - r for r in refine]   # child block of each
    nodes, leaf_lo, leaf_size = [("!", tuple(root))], [], []
    stack = [(0, i) for i in reversed(range(len(los[0])))]
    while stack:
        lev, i = stack.pop()
        if refine[lev][i]:
            nodes.append(("!", (2, 2, 2)))
            base = 8 * first[lev][i]
            stack.extend((lev + 1, base + k) for k in reversed(range(8)))
        else:
            nodes.append(("leaf", len(leaf_lo)))
            leaf_lo.append(los[lev][i])
            leaf_size.append(sizes[lev])
    lo = np.asarray(leaf_lo)
    hi = lo + np.asarray(leaf_size)
    return nodes, lo, hi, mass(lo, hi - lo)


def write_amr(path: str, nodes, rows: np.ndarray) -> None:
    """A Morton-order AMR text file: '!' lines, leaf rows from rows."""
    fmt = " ".join(["%.9e"] * rows.shape[1])
    with open(path, "w") as f:
        f.write("# RAMSES-style adaptive mesh, Morton order, x fastest\n")
        for kind, v in nodes:
            f.write(f"! {v[0]} {v[1]} {v[2]}\n" if kind == "!"
                    else fmt % tuple(rows[v]) + "\n")


def amr_columns(lo, hi, mass, unit: str = "kpc") -> dict:
    """The leaf columns of the AMR galaxy (boxes in `unit`, unit masses;
    "pc" shrinks the galaxy 1000-fold at the same optical depths): the gas
    density [Msun/pc3] whose metallicity share is the dust disk's
    (dust_disk_number entities of the MRN mix, face-on tau_V 1), the
    metallicity (0.02 e^-R/10 kpc within the SSP table's 0.004-0.05), the
    gas temperature, and for the source file the star-forming leaves'
    initial mass [Msun] (SNAP's m_stars over the densest sf_share of the
    leaves by gas mass), metallicity and age [yr] (seeded, 1e6-1e8)."""
    s = SNAP
    c = 0.5 * (lo + hi)
    R = np.hypot(c[:, 0], c[:, 1])
    Z = np.clip(0.02 * np.exp(-R / s["z_scale"]), 0.004, 0.05)
    vol_pc3 = np.prod(hi - lo, axis=-1) * (1e9 if unit == "kpc" else 1.0)
    dust_msun = mass * dust_disk_number(unit) * MU_MRN / MSUN_AMR
    rho = dust_msun / Z / vol_pc3
    T = 8000.0 * (1.0 + 0.5 * R / GALAXY["h_r"])
    dens = dust_msun / vol_pc3
    sf = dens >= np.quantile(dens, 1.0 - s["sf_share"])
    minit = np.where(sf, mass, 0.0)
    minit *= s["m_stars"] / minit.sum()
    age = np.exp(np.random.default_rng(s["seed"] + 1).uniform(
        np.log(1e6), np.log(1e8), len(lo)))
    return dict(rho=rho, Z=Z, T=T, minit=minit, age=age)


def sph_particles(n_gas: int, n_stars: int, unit: str = "kpc") -> tuple:
    """(gas rows x y z h [pc] M [Msun], star rows x y z h [pc] Minit
    [Msun] Z age [yr]) of the SPH galaxy: n_gas equal-mass particles of
    the dust disk (the dust mass of dust_disk_number, h the distance to
    the SNAP['ngb']-th neighbour) and n_stars of the stellar disk (SNAP's
    m_stars, fixed h, metallicities and ages seeded within the SSP
    table); `unit` as in amr_columns."""
    from scipy.spatial import cKDTree
    s, g = SNAP, GALAXY
    to_pc = 1e3 if unit == "kpc" else 1.0
    rs = np.random.default_rng(s["seed"] + 2)
    box = np.array([g["r_max"], g["r_max"], g["z_max"]])
    gas = _disk_points(rs, 2 * n_gas, g["dust_h_r"], g["dust_h_z"])
    gas = gas[np.all(np.abs(gas) < 0.98 * box, axis=1)][:n_gas]
    ngb = min(s["ngb"], len(gas) - 1)
    h = cKDTree(gas).query(gas, k=ngb + 1)[0][:, -1]
    m_gas = dust_disk_number(unit) * MU_MRN / MSUN_AMR / len(gas)
    stars = _disk_points(rs, 2 * n_stars, g["h_r"], g["h_z"])
    stars = stars[np.all(np.abs(stars) < 0.98 * box, axis=1)][:n_stars]
    n = len(stars)
    return (np.column_stack([gas * to_pc, h * to_pc,
                             np.full(len(gas), m_gas)]),
            np.column_stack([stars * to_pc, np.full(n, s["h_stars"] * to_pc),
                             np.full(n, s["m_stars"] / n),
                             rs.uniform(0.004, 0.05, n),
                             np.exp(rs.uniform(np.log(1e6), np.log(1e10),
                                               n))]))


def snapshot_ski(directory, name: str, kind: str = "amr", root=(2, 2, 2),
                 level: int = 8, threshold: float = 3e-5,
                 mode: str = "DustEmission", rf_bins: int = 25,
                 n_gas: int = SNAP["n_gas"], n_stars: int = SNAP["n_stars"],
                 npix: int = 64, nlam: int = 40, unit: str = "kpc") -> str:
    """A ski file of the imported galaxy written into directory with its
    data files, bench4's SSP table and the MRN mix: kind "amr" (an
    AdaptiveMeshMedium with importMetallicity and importTemperature on its
    AdaptiveMeshSpatialGrid, the mesh of amr_mesh(root, level, threshold),
    and an AdaptiveMeshSource of its star-forming leaves) or "sph" (a
    ParticleMedium of n_gas gas particles on a density octree of maxLevel
    `level`, a ParticleSource of n_stars star particles); mode
    DustEmission (an rf_bins-bin RF, bench4's emission grid) or
    ExtinctionOnly; a face-on and an edge-on FullInstrument of npix^2
    pixels on nlam log bins over 0.09-1000 micron, at GALAXY's distance.
    unit "pc" shrinks every length 1000-fold at the same optical depths
    (the reference's f32 tree diagonal and AMR span overflow past ~0.6
    kpc, and the tests hold the port against it)."""
    import shutil
    g = GALAXY
    R, Z = g["r_max"], g["z_max"]
    box = (f'minX="-{R} {unit}" maxX="{R} {unit}" minY="-{R} {unit}" '
           f'maxY="{R} {unit}" minZ="-{Z} {unit}" maxZ="{Z} {unit}"')
    ssp = ('<sedFamily type="SEDFamily"><FileSSPSEDFamily filename='
           '"bench4_ssp.stab" hasIonizationParameter="false"/></sedFamily>')
    mix = ('<materialMix type="MaterialMix"><MeanFileDustMix filename='
           '"mrn_mean.txt"/></materialMix>')
    if kind == "amr":
        nodes, lo, hi, mass = amr_mesh(root, level, threshold)
        col = amr_columns(lo, hi, mass, unit)
        write_amr(os.path.join(str(directory), f"{name}_gas.amr"), nodes,
                  np.column_stack([col["rho"], col["Z"], col["T"]]))
        write_amr(os.path.join(str(directory), f"{name}_stars.amr"), nodes,
                  np.column_stack([col["minit"], col["Z"], col["age"]]))
        source = (f'<AdaptiveMeshSource filename="{name}_stars.amr" {box} '
                  'importVelocity="false" sourceWeight="1" wavelengthBias='
                  f'"0.5">{ssp}</AdaptiveMeshSource>')
        medium = (f'<AdaptiveMeshMedium filename="{name}_gas.amr" {box} '
                  'massType="MassDensity" massFraction="1" importMetallicity'
                  '="true" importTemperature="true" maxTemperature="0 K" '
                  'importVelocity="false" importMagneticField="false" '
                  f'importVariableMixParams="false">{mix}'
                  '</AdaptiveMeshMedium>')
        grid = '<AdaptiveMeshSpatialGrid/>'
    else:
        gas, stars = sph_particles(n_gas, n_stars, unit)
        np.savetxt(os.path.join(str(directory), f"{name}_gas.txt"), gas,
                   header="x y z h (pc) M (Msun)")
        np.savetxt(os.path.join(str(directory), f"{name}_stars.txt"), stars,
                   header="x y z h (pc) Minit (Msun) Z t (yr)")
        kern = ('<smoothingKernel type="SmoothingKernel">'
                '<CubicSplineSmoothingKernel/></smoothingKernel>')
        source = (f'<ParticleSource filename="{name}_stars.txt" '
                  'importVelocity="false" useColumns="" sourceWeight="1" '
                  f'wavelengthBias="0.5">{kern}{ssp}</ParticleSource>')
        medium = (f'<ParticleMedium filename="{name}_gas.txt" '
                  'massType="Mass" massFraction="1" importMetallicity='
                  '"false" importTemperature="false" importVelocity="false" '
                  f'importMagneticField="false">{kern}{mix}</ParticleMedium>')
        grid = (f'<PolicyTreeSpatialGrid {box} treeType="OctTree"><policy '
                'type="TreePolicy"><DensityTreePolicy minLevel="2" maxLevel='
                f'"{level}" maxDustFraction="1e-6"/></policy>'
                '</PolicyTreeSpatialGrid>')
    emission = mode == "DustEmission"
    rf = ('<radiationFieldOptions type="RadiationFieldOptions">'
          '<RadiationFieldOptions storeRadiationField="true">'
          '<radiationFieldWLG type="DisjointWavelengthGrid">'
          '<LogWavelengthGrid minWavelength="0.09 micron" maxWavelength='
          f'"100 micron" numWavelengths="{rf_bins}"/></radiationFieldWLG>'
          '</RadiationFieldOptions></radiationFieldOptions>'
          '<dustEmissionOptions type="DustEmissionOptions">'
          '<DustEmissionOptions dustEmissionType="Equilibrium" '
          'includeHeatingByCMB="false" maxFractionOfPrimary="0.01" '
          'maxFractionOfPrevious="0.03" sourceWeight="1" wavelengthBias='
          '"0.5"><cellLibrary type="SpatialCellLibrary"><AllCellsLibrary/>'
          '</cellLibrary><dustEmissionWLG type="DisjointWavelengthGrid">'
          '<LogWavelengthGrid minWavelength="1 micron" maxWavelength='
          '"2000 micron" numWavelengths="40"/></dustEmissionWLG>'
          '</DustEmissionOptions></dustEmissionOptions>') if emission else ""
    fov = 2.2 * R
    inst = lambda iname, inc: (
        f'<FullInstrument instrumentName="{iname}" distance='
        f'"{g["distance_mpc"]} Mpc" inclination="{inc} deg" azimuth="0 deg" '
        f'roll="0 deg" fieldOfViewX="{fov} {unit}" numPixelsX="{npix}" '
        f'centerX="0 pc" fieldOfViewY="{fov} {unit}" numPixelsY="{npix}" '
        'centerY="0 pc" recordComponents="true" numScatteringLevels="0" '
        'recordPolarization="false" recordStatistics="true"/>')
    text = f"""<?xml version='1.0' encoding='UTF-8'?>
<skirt-simulation-hierarchy type="MonteCarloSimulation" format="9" producer="chip_smoke">
  <MonteCarloSimulation userLevel="Expert" simulationMode="{mode}" numPackets="{N_GEO}">
    <random type="Random"><Random seed="0"/></random>
    <units type="Units"><ExtragalacticUnits fluxOutputStyle="Wavelength"/></units>
    <cosmology type="Cosmology"><LocalUniverseCosmology/></cosmology>
    <sourceSystem type="SourceSystem"><SourceSystem minWavelength="0.09 micron" maxWavelength="100 micron" sourceBias="0.5"><sources type="Source">{source}</sources></SourceSystem></sourceSystem>
    <mediumSystem type="MediumSystem"><MediumSystem>
      <photonPacketOptions type="PhotonPacketOptions"><PhotonPacketOptions forceScattering="true" minWeightReduction="1e4" minScattEvents="0" pathLengthBias="0.5"/></photonPacketOptions>
      {rf}
      <media type="Medium">{medium}</media>
      <grid type="SpatialGrid">{grid}</grid>
    </MediumSystem></mediumSystem>
    <instrumentSystem type="InstrumentSystem"><InstrumentSystem><defaultWavelengthGrid type="WavelengthGrid"><LogWavelengthGrid minWavelength="0.09 micron" maxWavelength="1000 micron" numWavelengths="{nlam}"/></defaultWavelengthGrid><instruments type="Instrument">{inst("i0", 0)}{inst("i90", 90)}</instruments></InstrumentSystem></instrumentSystem>
  </MonteCarloSimulation>
</skirt-simulation-hierarchy>
"""
    path = os.path.join(str(directory), f"{name}.ski")
    with open(path, "w") as f:
        f.write(text)
    for fn in ("mrn_mean.txt", "bench4_ssp.stab"):
        shutil.copy(os.path.join(GOLDEN, fn), str(directory))
    return path


# the configurations of this section: (snapshot_ski's arguments, run
# sizes); the full-width ones at N_GEO packets in batches of B_GEO, the
# reduced ones of tests/test_torch_amr.py, tests/test_torch_imports.py and
# draw_for_draw_imports
SNAPSHOTS = {
    "amr_galaxy": (dict(), dict(num_packets=N_GEO, batch_size=B_GEO,
                                max_events=24)),
    "amr_galaxy_march": (dict(root=(3, 3, 3), mode="ExtinctionOnly"),
                         dict(num_packets=N_GEO, batch_size=B_GEO,
                              max_events=24)),
    "sph_galaxy": (dict(kind="sph"), dict(num_packets=N_GEO, batch_size=B_GEO,
                                          max_events=24)),
    "amr_galaxy_small": (dict(level=4, threshold=3e-3, rf_bins=4, npix=16,
                              nlam=12, unit="pc"),
                         dict(num_packets=1024, batch_size=1024,
                              max_events=3)),
    "amr_galaxy_march_small": (dict(root=(3, 3, 3), level=5, threshold=1e-3,
                                    mode="ExtinctionOnly", npix=16, nlam=12,
                                    unit="pc"),
                               dict(num_packets=2048, batch_size=1024,
                                    max_events=4)),
    "sph_galaxy_small": (dict(kind="sph", level=4, n_gas=1000, n_stars=100,
                              rf_bins=4, npix=16, nlam=12, unit="pc"),
                         dict(num_packets=1024, batch_size=1024,
                              max_events=3)),
}


def snapshot_config(name: str, device, directory, **run):
    """SNAPSHOTS[name] through the port's load_ski (its run sizes updated
    by run)."""
    from skirt9_tpu_torch.config.ski import load_ski
    kw, sizes = SNAPSHOTS[name]
    return load_ski(snapshot_ski(directory, name, **kw), device=device,
                    **dict(sizes, **run))


# tests/test_amr.py's meshes, for the march kernel's checks
AMR_TWO_LEVEL = ("! 2 2 2\n! 2 2 2\n"
                 + "".join(f"{v}\n" for v in range(1, 16)))


def amr_deep_text(rs, root=(3, 3, 3)) -> str:
    """tests/test_amr.py's random 3-level mesh under root: children refined
    2x2x2, grandchildren 2x1x2, at random."""
    lines = ["! %d %d %d" % root]
    for _ in range(int(np.prod(root))):
        if rs.random() < 0.4:
            lines.append("! 2 2 2")
            for _ in range(8):
                if rs.random() < 0.3:
                    lines.append("! 2 1 2")
                    lines.extend("0.5" for _ in range(4))
                else:
                    lines.append("0.5")
        else:
            lines.append("0.5")
    return "\n".join(lines) + "\n"


def amr_leaf_depth(grid):
    """(ncells,) levels of descent that end in each leaf of an adaptive
    mesh, from its node tables (nodes in file order: a parent before its
    children)."""
    import torch
    child = grid.node_child.cpu().numpy()
    div = grid.node_div.cpu().numpy()
    flat = grid.child_flat.cpu().numpy()
    depth = np.zeros(len(child), np.int64)
    for n in np.flatnonzero(child >= 0):
        k = int(np.prod(div[n]))
        depth[flat[child[n]:child[n] + k]] = depth[n] + 1
    cells = grid.node_cell.cpu().numpy()
    out = np.zeros(grid.ncells, np.int64)
    out[cells[cells >= 0]] = depth[cells >= 0]
    return torch.tensor(out, device=grid.cell_lo.device)


def _random_lanes(torch, grid, B: int, seed: int):
    """B lanes in the grid's box (an eighth on leaf corners) with isotropic
    directions, on the grid's device, and their cells."""
    rs = np.random.default_rng(seed)
    lo = grid.box_lo.double().cpu().numpy()
    hi = grid.box_hi.double().cpu().numpy()
    pos = lo + (hi - lo) * rs.uniform(0.0, 1.0, (B, 3))
    clo = grid.cell_lo.double().cpu().numpy()
    pos[:B // 8] = clo[rs.integers(0, len(clo), B // 8)]
    d = rs.normal(size=(B, 3))
    dev = grid.cell_lo.device
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    pos = t32(pos)
    dirn = t32(d / np.linalg.norm(d, axis=1, keepdims=True))
    return pos, dirn, grid.locate(pos)


def phase_kernels_march_amr(torch) -> dict:
    """The march kernel's adaptive-mesh mode against its plain version
    (_march_check, bit for bit): on tests/test_amr.py's two-level mesh and
    its 3 3 3 / 2 2 2 / 2 1 2 mesh (2^16 random lanes each, S = their
    max_steps), and on amr_galaxy_march's 3 3 3 root at its first event
    (2^16 lanes, S = 256), the main path's shape."""
    from skirt9_tpu_torch import device
    from skirt9_tpu_torch.grids import amr
    dev = device.resolve("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, text in (("amr_two_level", AMR_TWO_LEVEL),
                           ("amr_deep", amr_deep_text(
                               np.random.default_rng(5)))):
            path = os.path.join(tmp, f"{name}.amr")
            with open(path, "w") as f:
                f.write(text)
            grid = amr.build_amr(path, ((-PC, PC),) * 3)[0].to(dev)
            pos, dirn, cell = _random_lanes(torch, grid, B_GEO, 31)
            out[name] = _march_check(torch, "march_amr", grid, pos, dirn,
                                     cell, min(grid.max_steps(), 256),
                                     cell >= 0)
        sim = snapshot_config("amr_galaxy_march", "cuda", tmp)
        S = sim.options.max_steps
        require(sim._sweep_tabs is None and S == min(sim.grid.max_steps(),
                                                     256),
                f"amr_galaxy_march marches ({S} steps)")
        pos, dirn, cell, alive = _first_event_lanes(torch, sim, B_GEO)
        out["march_amr"] = _march_check(torch, "march_amr", sim.grid, pos,
                                        dirn, cell, S, alive)
        del sim
    torch.cuda.empty_cache()
    emit({"phase": "kernels_march_amr", **out})
    return out


def _kernel5_grouped(torch, sim, pkt, opts, pre, what: str) -> dict:
    """Kernel 5's grouped mode on one event (first_event_b3: pkt, opts,
    pre) into the RF rows against its plain version: the RF within 1e-6
    of its maximum, s_int, icell and found identical; timed, with its
    bound (as phase_kernels_b3)."""
    from skirt9_tpu_torch.transport import mlsweep as ml
    tabs = sim._sweep_tabs
    rec, cells, _, tb, tot, lane = pre
    B, n_groups = pkt.lam.shape[0], opts.rf_strata
    nbins = len(sim.rf_borders) - 1
    ncells = tabs.nd.shape[0]
    rs = np.random.default_rng(9)
    inv_sqrt = 1.0 / math.sqrt(sim.rf_scale)
    rfb = sim._rf_borders_dev
    in_rf = (pkt.lam >= rfb[0]) & (pkt.lam < rfb[-1])
    lum_half = (pkt.lum * (pkt.alive & in_rf)) * inv_sqrt
    tau_int = torch.tensor(rs.uniform(size=B), dtype=torch.float32,
                           device=sim.device) * tot
    bin_map = torch.tensor(opts.rf_bin_map, dtype=torch.int32,
                           device=sim.device)
    args = (tabs, pkt.pos, pkt.dir, pkt.alive, rec, cells, lum_half, tau_int,
            tb, inv_sqrt)
    kw = dict(n_groups=n_groups, lane=lane, bin_map=bin_map, nbins=nbins)
    rf_k, s_k, c_k, f_k = ml.sweep_deposit(*args, **kw)
    rf_p, s_p, c_p, f_p = ml.sweep_deposit_plain(*args, **kw)
    torch.cuda.synchronize()
    require(int(f_p.sum()) > B // 2, f"{what}: test rays interact")
    require(bool(torch.equal(f_k, f_p)), f"{what}: found identical")
    require(bool(torch.equal(s_k[f_k], s_p[f_p])), f"{what}: s_int identical")
    require(bool(torch.equal(c_k, c_p)), f"{what}: interaction cells equal")
    require(rf_k.shape == rf_p.shape == (nbins, ncells), f"{what}: RF rows")
    rf_err = float((rf_k - rf_p).abs().max())
    rf_max = float(rf_p.abs().max())
    require(rf_max > 0 and rf_err <= 1e-6 * rf_max,
            f"{what}: rf error {rf_err} <= 1e-6 * {rf_max}")
    rows_lit = int((rf_p.abs().sum(dim=1) > 0).sum())
    g, smin, smax = lane
    dep = (tabs, pkt.pos, pkt.dir, g, smin, smax, rec, cells, lum_half,
           tau_int, tb, inv_sqrt, n_groups, bin_map, nbins)
    del rf_p
    plain_ms = cuda_ms(lambda: ml._deposit_plain(*dep), reps=3)
    torch.cuda.empty_cache()
    n_live = int(ml._plan_substeps(tabs, pkt.pos, pkt.dir, g, smin,
                                   smax)[3].sum())
    return dict(
        max_abs_err=rf_err, rf_max=rf_max, err_of_max=rf_err / rf_max,
        n_groups=n_groups, rows=nbins, rows_lit=rows_lit, leaves=ncells,
        shared_table=ncells <= ml.SHARED_LEAVES, live_pairs=n_live,
        live_share=n_live / (tabs.n_steps * B),
        ms=cuda_ms(lambda: ml._deposit_cuda(*dep)),
        device_ms=device_ms(lambda: ml._deposit_cuda(*dep))["ours"],
        plain_ms=plain_ms, library_ms=None,
        **bound(lane_bytes(B, 0) + 8 * B + n_live * (3 * 4 + 3 * 4 + 4)
                + 2 * tabs.n_steps * 4 + n_groups * 4 + nbins * ncells * 4
                + 8 * B,
                n_live * (OPS_SLAB + 3 + 3 * (OPS_SUB + OPS_DEP))))


def phase_kernels_amr(torch) -> dict:
    """Kernels 4-7 at amr_galaxy's shapes, against their plain versions:
    at its first event (the first stratified batch of its mesh source,
    2^16 lanes in 32 lane groups) kernel 4's prefix and total modes and
    kernel 5's grouped mode into the 25 RF rows on the tree sweep's tables
    (a 256^3 fine raster); then, on the same mesh's voxel raster (the XL
    tables with the cell map), kernel 6's prefix mode and kernel 7's
    grouped prefix mode. Timed, with bounds."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.transport import mlsweep as ml
    from skirt9_tpu_torch.transport import sweepxl as xl
    with tempfile.TemporaryDirectory() as tmp:
        sim = snapshot_config("amr_galaxy", "cuda", tmp)
    tabs = sim._sweep_tabs
    fine = tabs.n
    require(isinstance(tabs, ml.MLTables),
            f"amr_galaxy on the tree sweep ({type(tabs).__name__})")
    pkt, opts, pre = first_event_b3(torch, sim)
    require(opts.rf_strata > 1, f"amr_galaxy runs lane groups "
            f"({opts.rf_strata})")
    sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T.contiguous()
    out = _kernel4_b4(torch, sim, pkt, sig, "amr_galaxy")
    out["mlsweep_deposit"] = _kernel5_grouped(
        torch, sim, pkt, opts, pre, f"kernel 5 on amr_galaxy "
        f"({sim.grid.ncells} leaves)")
    del pkt, pre
    torch.cuda.empty_cache()
    sim._sweep_tabs = xl.build_tree_tables(sim.grid, sim.medium)
    tabs = sim._sweep_tabs
    require(tabs.n == fine and tabs.cellmap is not None,
            "amr_galaxy's voxel raster")
    rays, opts, n_groups, pre = first_event_xl(torch, sim)
    out["sweepxl_dtau_prefix"] = check_prefix_xl(
        torch, "kernel 6 on amr_galaxy's voxel raster", tabs, rays, pre)
    bin_map = torch.tensor(opts.rf_bin_map, dtype=torch.int32,
                           device=sim.device)
    out["sweepxl_deposit_prefix"] = check_grouped_xl(
        torch, "kernel 7 on amr_galaxy's voxel raster", sim, rays, pre,
        n_groups, bin_map, len(sim.rf_borders) - 1)
    del rays, pre
    torch.cuda.empty_cache()
    # one batch of the primary emission through the XL engine on the
    # voxel raster: the path an AMR mesh past a 256 raster takes
    sim.num_packets = B_GEO
    (rf, _), launches = drive(XL + DETECT, RESIDENT + ML + MARCH_AMR,
                              lambda: sim.run_primary(verbose=False))
    require(bool(torch.isfinite(rf).all()) and float(rf.sum()) > 0,
            "amr_galaxy's RF on its voxel raster")
    out["xl_run_launches"] = {k: v for k, v in launches.items() if v}
    emit({"phase": "kernels_amr", "batch": B_GEO, "lane_groups": n_groups,
          "leaves": sim.grid.ncells, "fine_grid": list(fine), **out})
    del sim, rf
    torch.cuda.empty_cache()
    return out


def phase_draw_for_draw_imports(torch) -> dict:
    """The reduced snapshot configurations on the CPU (plain versions) and
    on the card (kernels), the same seed: amr_galaxy_small (the tree
    sweep, kernels 4-5) and sph_galaxy_small (a density octree of SPH
    gas, kernels 4-5) with dust emission, amr_galaxy_march_small (the 3 3
    3 root on march_amr); march_gaps' bounds (the RF and each primary SED
    kind within 2e-5 of its maximum, the secondary kinds' sums 1e-3)."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, must in (("amr_galaxy_small", ML),
                           ("amr_galaxy_march_small", MARCH_AMR),
                           ("sph_galaxy_small", ML)):
            runs = []
            for dev in ("cpu", "cuda"):
                sim = snapshot_config(name, dev, tmp)
                dust = sim.ems_borders is not None
                run = (lambda s=sim: s.run_with_dust_emission(verbose=False)) \
                    if dust else (lambda s=sim: s.run_primary(verbose=False))
                if dev == "cpu":
                    runs.append(run())
                else:
                    res, launches = drive(must + DETECT, (), run)
                    runs.append(res)
            gaps = march_gaps(runs[0], runs[1], dust)
            out[name] = dict(gaps=gaps, launches={k: v for k, v in
                                                  launches.items() if v})
            if dust:
                e = abs(runs[1][2]["L_dust"] / runs[0][2]["L_dust"] - 1)
                require(e <= 1e-4, f"{name}: L_dust CPU against card {e}")
                out[name]["L_dust_rel_err"] = e
    emit({"phase": "draw_for_draw_imports", **out})
    return out


def ssp_entity_luminosities(path: str, minit, Z, age, lam_range):
    """Each entity's luminosity [W] over lam_range from an SSP table, on
    the host in f64: the table's spectra (per Msun, ages in years)
    interpolated linearly onto the range clipped at its ends, mixed
    geometrically between the parameter-grid corners (metallicity
    linear, age logarithmic, as the family's axes say), integrated by the
    trapezoid rule, times the initial mass."""
    from skirt9_tpu_torch.utils.storedtable import read_stored_table
    tab = read_stored_table(path)
    lam = tab.axes_points[0]
    Zs, ts = tab.axes_points[1], tab.axes_points[2]
    q = tab.quantity(tab.quantity_names[0])      # (t, Z, lambda)
    lo, hi = lam_range
    lam_c = np.unique(np.concatenate([[lo], lam[(lam >= lo) & (lam <= hi)],
                                      [hi]]))
    L = np.stack([[np.interp(lam_c, lam, q[it, iz]) for iz in range(len(Zs))]
                  for it in range(len(ts))])      # (t, Z, lam_c)

    def frac(x, pts, log):
        x, pts = (np.log(x), np.log(pts)) if log else (x, pts)
        j = np.clip(np.searchsorted(pts, x) - 1, 0, len(pts) - 2)
        f = np.clip((x - pts[j]) / (pts[j + 1] - pts[j]), 0.0, 1.0)
        return j, f
    jz, fz = frac(np.asarray(Z, np.float64), Zs, False)
    jt, ft = frac(np.asarray(age, np.float64), ts, True)
    logL = np.log(np.maximum(L, 1e-300))
    out = np.zeros(len(jz))
    for i in np.flatnonzero(np.asarray(minit) > 0):
        spec = np.exp((1 - ft[i]) * ((1 - fz[i]) * logL[jt[i], jz[i]]
                                     + fz[i] * logL[jt[i], jz[i] + 1])
                      + ft[i] * ((1 - fz[i]) * logL[jt[i] + 1, jz[i]]
                                 + fz[i] * logL[jt[i] + 1, jz[i] + 1]))
        out[i] = minit[i] * np.trapezoid(spec, lam_c)
    return out


def launch_weight_sigma(torch, sim, n: int = 1 << 20) -> float:
    """The relative standard error of a primary run's transparent SED
    integral: the standard deviation of the first source's launch weights
    over n launches, stratified as the primary segment strata them, over
    their mean and the square root of the run's packets."""
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.sources import base as src
    strata = sim._strata_for(sim.sources[0], sim.options)
    B, stabs = sim.batch_size, sim._src_tabs[0]
    lanes = torch.arange(B, device=sim.device)
    if strata is not None:
        B, stabs, _, lanes = sim._stratify(strata, stabs, sim.options, n)
    lums = [src.launch_batch(sim.sources[0], stabs, sim.grid,
                             rng.seed_key(sim.seed + 5, sim.device),
                             b * B + lanes, n).lum.double()
            for b in range(max(n // B, 1))]
    lum = torch.cat(lums)
    return float(lum.std() / lum.mean()) / math.sqrt(sim.num_packets)


def transparent_gate(torch, sim, L_host: float, n_sigma: float = 5.0) -> dict:
    """A primary run's transparent SED (the first instrument's file, in
    W/m2/micron) integrated over its bins times 4 pi d^2 against the
    entities' luminosity L_host [W], within n_sigma of the launch weights'
    standard error (launch_weight_sigma)."""
    _, accs = sim.run_primary(verbose=False)
    cfg = sim.instruments[0]
    d = GALAXY["distance_mpc"] * 1e6 * 3.08567758149e16
    with tempfile.TemporaryDirectory() as tmp:
        cols = np.loadtxt([p for p in sim.write_outputs(accs, "t", tmp)
                           if p.endswith("_sed.dat")][0])
    borders = np.asarray(cfg.wave_borders, np.float64) * 1e6
    flux = float((cols[:, 2] * np.diff(borders)).sum())   # W/m2
    ratio = flux * 4 * math.pi * d ** 2 / L_host
    sigma = launch_weight_sigma(torch, sim)
    require(abs(ratio - 1) <= n_sigma * sigma,
            f"transparent SED's integral over the entities' luminosity "
            f"{ratio} within {n_sigma} sigma ({sigma})")
    return dict(transparent_over_entities=ratio, sigma=sigma,
                sigmas=abs(ratio - 1) / sigma, packets=sim.num_packets)


def chi2_gate(counts, expect, what: str, n_sigma: float = 3.0) -> dict:
    """Chi-square of counts against expected counts over the bins that
    expect at least 5, its z-score against its degrees of freedom within
    n_sigma."""
    use = expect >= 5
    chi2 = float((((counts - expect) ** 2 / np.maximum(expect, 1e-300))
                  [use]).sum())
    dof = int(use.sum()) - 1
    z = (chi2 - dof) / math.sqrt(2 * dof)
    require(z <= n_sigma, f"{what}: chi-square {chi2} on {dof} dof, {z} "
            f"sigma <= {n_sigma}")
    return dict(chi2=chi2, dof=dof, sigmas=z,
                lost=float(counts[~use].sum()), lost_expect=float(
                    expect[~use].sum()))


def tau_gate(torch, sim, n: int = 1 << 14) -> dict:
    """tau at 0.55 micron along n seeded rays from inside the disk through
    the tree sweep's tables (kernel 4's total mode) and through march_amr
    (the march kernel, S = the run's max_steps), on the rays with tau >
    0.01 that the march takes to the grid's edge within S steps (the
    shares it cuts short or that stall on a face, as the reference's march
    does, are reported): within
    1e-4 relative plus what the march skips by design, the 1e-6 of the
    diagonal it moves on past every face (the reference's AMR step), at
    most twice the nudge times the larger opacity of the two cells at
    each face (the nudge itself, and a thinner cell it crosses)."""
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.transport import march as mr
    from skirt9_tpu_torch.transport import mlsweep as ml
    rs = np.random.default_rng(41)
    box = (sim.grid.box_hi - sim.grid.box_lo).double().cpu().numpy()
    pos = np.stack([rs.normal(0, 0.1, n), rs.normal(0, 0.1, n),
                    rs.normal(0, 0.025, n)], -1) * box
    d = rs.normal(size=(n, 3))
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32),
                                 device=sim.device)
    pos, dirn = t32(pos), t32(d / np.linalg.norm(d, axis=1, keepdims=True))
    cell = sim.grid.locate(pos)
    act = cell >= 0
    opt = msys.optics_at(sim.medium, torch.full((n,), 0.55e-6,
                                                device=sim.device))
    t_ml = ml.sweep_tau_total(sim._sweep_tabs, pos, dirn,
                              opt.sigma_ext.T.contiguous(), act)
    S = sim.options.max_steps
    cells, ds = mr.march_geometry(sim.grid, pos, dirn, cell, S, act)
    t_mr = mr.opacity_on_path(sim.medium, opt, cells, ds, dirn).sum(dim=0)
    kappa = (sim.medium.nd.double() @ opt.sigma_ext[0].double())
    k = kappa[cells.long()] * (ds > 0)                     # (S, B)
    k_face = torch.maximum(k, torch.cat([k[1:], torch.zeros_like(k[:1])]))
    skipped = 2.0 * sim.grid.nudge() * k_face.sum(dim=0)
    # a lane that left the grid records cell 0 and length 0; one that
    # stalls on a face (its nudge below an ulp of a coordinate) keeps its
    # cell with length 0, as the reference's march does
    done = act & (ds[-1] == 0) & (cells[-1] == 0)
    stalled = act & (ds[-1] == 0) & (cells[-1] != 0)
    big = done & (t_mr > 0.01)
    gap = (t_ml.double() - t_mr.double()).abs()
    excess = ((gap - skipped) / t_mr.double().clamp_min(1e-30))[big]
    rel = float((gap / t_mr.double().clamp_min(1e-30))[big].max())
    require(int(big.sum()) > n // 4 and float(excess.max()) <= 1e-4,
            f"tau: tree sweep against march_amr within 1e-4 beyond the "
            f"march's nudges ({float(excess.max())}, {int(big.sum())} rays)")
    return dict(rays=int(big.sum()), max_rel_err=rel,
                max_excess_over_nudges=float(excess.max()), steps=S,
                nudge_m=sim.grid.nudge(),
                cut_short=float((act & (ds[-1] != 0)).sum() / act.sum()),
                stalled=float(stalled.sum() / act.sum()),
                median_tau=float(t_mr[big].median()))


def _run_phase(torch, sim, must, dust: bool):
    """A timed run of a configuration on the card, after a warm-up of one
    batch: the kernels in must and detect launched, no other sweep or
    march kernel."""
    run = (lambda: sim.run_with_dust_emission(verbose=False)) if dust \
        else (lambda: sim.run_primary(verbose=False))
    t0 = time.perf_counter()
    out, launches = drive(must + DETECT, tuple(
        k for k in SWEEPS + MARCH + MARCH_TREE + MARCH_CURVI + MARCH_AMR
        + MARCH_POLAR + MARCH_TETRA + MARCH_CLUMPY if k not in must), run)
    return out, launches, time.perf_counter() - t0


def phase_full_width_amr(torch, smi: str, name: str = "amr_galaxy") -> dict:
    """amr_galaxy (about 10^5 leaves of a 2 2 2 root to level 8, the tree
    sweep on its 256^3 raster: kernels 4-5, detect; dust emission with a
    25-bin RF; 2^20 packets in batches of 2^16, 24 events) or
    amr_galaxy_march (the 3 3 3 root: march_amr, ExtinctionOnly), timed
    after a one-batch warm-up. Gates: the medium's dust entities on the
    grid against the file's (1e-6); for amr_galaxy L_dust = L_abs_primary
    (1e-4) and tau along seeded rays, the tree sweep against march_amr
    (tau_gate); for amr_galaxy_march 2^22 launch positions over the leaves
    against the leaves' luminosity cdf (3 sigma) and a primary run's
    transparent SED against the leaves' luminosities (5 sigma); one batch
    profiled (host_per_event)."""
    from skirt9_tpu_torch.grids import amr
    from skirt9_tpu_torch.ops import rng
    dust = name == "amr_galaxy"
    must = ML if dust else MARCH_AMR
    res = {"phase": f"full_width_{name.replace('_galaxy', '')}"}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sim = snapshot_config(name, "cuda", tmp)
        res["setup_s"] = time.perf_counter() - t0
        require(isinstance(sim.grid, amr.AMRGrid), f"{name} on its mesh")
        kw = SNAPSHOTS[name][0]
        unit = kw.get("unit", "kpc")
        nodes, lo, hi, mass = amr_mesh(kw.get("root", (2, 2, 2)),
                                       kw.get("level", 8),
                                       kw.get("threshold", 3e-5))
        col = amr_columns(lo, hi, mass, unit)
        to_m = 3.08567758149e16 * (1e3 if unit == "kpc" else 1.0)
        vol = np.prod(hi - lo, axis=-1) * to_m ** 3
        n_file = float((col["rho"] * col["Z"] * (MSUN_AMR / PC_AMR ** 3)
                        / MU_MRN * vol).sum())
        n_grid = float((sim.medium.nd[:, 0].double().cpu().numpy()
                        * sim.grid.volumes()).sum())
        e = abs(n_grid / n_file - 1)
        require(e <= 1e-6, f"{name}: dust on the grid against the file {e}")
        res.update(leaves=sim.grid.ncells, depth=sim.grid.depth,
                   dust_entities=n_grid, dust_rel_err=e,
                   max_steps=sim.options.max_steps)
        one_batch(sim, sim.run_primary)            # warm-up
        out, launches, dt = _run_phase(torch, sim, must, dust)
        res.update(packets=sim.num_packets, batch=sim.batch_size,
                   seconds=dt, packets_per_s=sim.num_packets / dt,
                   events=sim.last_stats.get("events"),
                   launches={k: v for k, v in launches.items() if v})
        L_host = ssp_entity_luminosities(
            os.path.join(tmp, "bench4_ssp.stab"), col["minit"], col["Z"],
            col["age"], sim.sources[0].family_tables.lam_range)
        if dust:
            info = out[2]
            e_l = abs(info["L_dust"] / info["L_abs_primary"] - 1)
            require(e_l <= 1e-4, f"{name}: L_dust / L_abs_primary - 1 {e_l}")
            res.update(iterations=info["iterations"], L_dust=info["L_dust"],
                       L_abs_primary=info["L_abs_primary"],
                       L_dust_rel_err=e_l, tau=tau_gate(torch, sim))
        else:
            n = 1 << 22
            counts = torch.zeros(sim.grid.ncells, dtype=torch.float64,
                                 device=sim.device)
            src, tabs = sim.sources[0], sim._src_tabs[0]
            for b in range(n // (1 << 20)):
                hist = torch.arange(b << 20, (b + 1) << 20, device=sim.device)
                keys = rng.event_keys(rng.history_keys(rng.seed_key(
                    97, sim.device), hist), rng.LAUNCH_EVENT)
                cell = sim.grid.locate(src.launch(tabs, keys, n)["pos"])
                require(bool((cell >= 0).all()), "launches inside the mesh")
                counts += torch.bincount(cell, minlength=sim.grid.ncells
                                         ).double()
            res["sampling"] = chi2_gate(
                counts.cpu().numpy(), n * L_host / L_host.sum(),
                f"{name}'s launch positions over the leaves")
            sim.num_packets = 1 << 18
            res["transparent"] = transparent_gate(torch, sim, L_host.sum())
        res["source_luminosity_W"] = float(L_host.sum())
        sim.num_packets = B_GEO
        res["breakdown"] = host_per_event(
            torch, sim, (lambda s: s.run_with_dust_emission(verbose=False))
            if dust else (lambda s: s.run_primary(verbose=False)), warm=True)
        del sim
    torch.cuda.empty_cache()
    emit(dict(res, device=torch.cuda.get_device_name(0), nvidia_smi=smi))
    return launches


def phase_full_width_sph(torch, smi: str) -> dict:
    """sph_galaxy: 10^5 gas particles (ParticleMedium, cubic spline) on a
    density octree of maxLevel 8 and 2*10^4 star particles
    (ParticleSource, bench4's SSP family), dust emission with a 25-bin
    RF on the tree sweep (kernels 4-5, detect), 2^20 packets in batches of
    2^16, 24 events, after a one-batch warm-up; the set-up seconds (the
    tree refined on the kernel-smoothed density) recorded. Gates: the
    resampled dust on the grid against the particles' (within 5%: cell
    centres sample the kernel sum), L_dust = L_abs_primary (1e-4), 2^22
    launch positions' kernel radii against the cubic spline's mass cdf
    and their particles against the particles' luminosity cdf (3 sigma
    each), a primary run's transparent SED against the particles'
    luminosities (5 sigma); one batch profiled. The radii are held to the
    cubic spline's cdf as the reference tabulates it (a 513-point running
    sum, which puts a few 1e-3 of the mass half a point inward: 2^22
    launches see that against the exact cdf)."""
    from skirt9_tpu_torch.grids.octree import OctreeGrid
    from skirt9_tpu_torch.imports import snapshots as snap
    from skirt9_tpu_torch.ops import rng
    res = {"phase": "full_width_sph"}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sim = snapshot_config("sph_galaxy", "cuda", tmp)
        res["setup_s"] = time.perf_counter() - t0
        require(isinstance(sim.grid, OctreeGrid), "sph_galaxy's octree")
        gas = np.loadtxt(os.path.join(tmp, "sph_galaxy_gas.txt"))
        stars = np.loadtxt(os.path.join(tmp, "sph_galaxy_stars.txt"))
        n_file = float(gas[:, 4].sum() * 1.98892e30 / MU_MRN)
        n_grid = float((sim.medium.nd[:, 0].double().cpu().numpy()
                        * sim.grid.volumes()).sum())
        e = abs(n_grid / n_file - 1)
        require(e <= 0.05, f"sph_galaxy: dust on the grid against the "
                f"particles' {e} <= 0.05")
        res.update(leaves=sim.grid.ncells, levels=sim.grid.levels,
                   gas_particles=len(gas), star_particles=len(stars),
                   dust_entities=n_grid, dust_rel_err=e)
        one_batch(sim, sim.run_primary)            # warm-up
        out, launches, dt = _run_phase(torch, sim, ML, True)
        info = out[2]
        e_l = abs(info["L_dust"] / info["L_abs_primary"] - 1)
        require(e_l <= 1e-4, f"sph_galaxy: L_dust / L_abs_primary - 1 {e_l}")
        res.update(packets=sim.num_packets, batch=sim.batch_size, seconds=dt,
                   packets_per_s=sim.num_packets / dt,
                   events=sim.last_stats.get("events"),
                   launches={k: v for k, v in launches.items() if v},
                   iterations=info["iterations"], L_dust=info["L_dust"],
                   L_abs_primary=info["L_abs_primary"], L_dust_rel_err=e_l)
        src, tabs = sim.sources[0], sim._src_tabs[0]
        L_host = ssp_entity_luminosities(
            os.path.join(tmp, "bench4_ssp.stab"), stars[:, 4], stars[:, 5],
            stars[:, 6], src.family_tables.lam_range)
        n = 1 << 22
        counts = torch.zeros(len(stars), dtype=torch.float64,
                             device=sim.device)
        q_edges = np.linspace(0.0, 1.0, 21)
        q_counts = np.zeros(20)
        pos_t = torch.tensor(stars[:, :3] * 3.08567758149e16,
                             dtype=torch.float64, device=sim.device)
        h_t = torch.tensor(stars[:, 3] * 3.08567758149e16,
                           dtype=torch.float64, device=sim.device)
        # the loader reads pc through its units: the same conversion
        require(np.allclose(src.snapshot.positions, pos_t.cpu().numpy(),
                            rtol=1e-12, atol=0), "star positions in m")
        for b in range(n // (1 << 20)):
            hist = torch.arange(b << 20, (b + 1) << 20, device=sim.device)
            keys = rng.event_keys(rng.history_keys(rng.seed_key(
                98, sim.device), hist), rng.LAUNCH_EVENT)
            p = snap._pick(tabs, keys)
            pos = src.launch(tabs, keys, n)["pos"].double()
            q = ((pos - pos_t[p]).norm(dim=1) / h_t[p]).cpu().numpy()
            q_counts += np.histogram(np.minimum(q, 1 - 1e-12), q_edges)[0]
            counts += torch.bincount(p, minlength=len(stars)).double()
        # the cubic spline's mass cdf as the reference tabulates it: the
        # running sum of W(q) q^2 on 513 points, linear between them
        qq = np.linspace(0.0, 1.0, 513)
        w = np.where(qq < 0.5, 1 - 6 * qq ** 2 + 6 * qq ** 3,
                     2 * (1 - qq) ** 3) * qq ** 2
        cum = np.cumsum(w)
        shares = np.diff(np.interp(q_edges, qq, cum / cum[-1]))
        res["kernel_radii"] = chi2_gate(q_counts, n * shares,
                                        "star launches' kernel radii")
        res["sampling"] = chi2_gate(counts.cpu().numpy(),
                                    n * L_host / L_host.sum(),
                                    "star launches over the particles")
        res["source_luminosity_W"] = float(L_host.sum())
        sim.num_packets = 1 << 18
        res["transparent"] = transparent_gate(torch, sim, L_host.sum())
        sim.num_packets = B_GEO
        res["breakdown"] = host_per_event(
            torch, sim, lambda s: s.run_with_dust_emission(verbose=False),
            warm=True)
        del sim
    torch.cuda.empty_cache()
    emit(dict(res, device=torch.cuda.get_device_name(0), nvidia_smi=smi))
    return launches


# ------------------------------------------ polar grids and unstructured meshes
# The 2D and 3D spheres, the 3D cylinder and the tetrahedral mesh on the
# march kernel's modes march_sphere2d, march_sphere3d, march_cylinder3d and
# march_tetra; the tetrahedral mesh and a density-sampled, Lloyd-relaxed
# Voronoi mesh also on their rasters (kernels 4-5).
MARCH_POLAR = ("march_sphere2d", "march_sphere3d", "march_cylinder3d")
MARCH_TETRA = ("march_tetra",)
# f32 operations per walked (step, lane): a tetrahedron's four faces (two
# dot products, the division, the test) and the move; a polar step's sphere
# quadratics (24), per cone its sums and quadratic with both roots and the
# choice (45), per half-plane its crossing and side test (14), and the
# relocation (the move, the radius or hypot, per atan2 about 40, a binary
# search of ~7 comparisons per coordinate)
OPS_MARCH.update(march_tetra=76, march_sphere2d=24 + 2 * 45 + 70,
                 march_sphere3d=24 + 2 * 45 + 2 * 14 + 120,
                 march_cylinder3d=40 + 2 * 14 + 80)
MODES_OF.update(Sphere2DGrid="march_sphere2d", Sphere3DGrid="march_sphere3d",
                Cylinder3DGrid="march_cylinder3d", TetraGrid="march_tetra")
# a SKIRTOR-style AGN torus (the reference's TorusGeometry): rho ~ r^-p
# exp(-q |cos theta|) within 40 deg of the equator from 0.05 to 15 pc, of
# equatorial tau_V = 5 from the centre, around a central 20,000 K blackbody
# of 1e11 Lsun over 0.1-3 micron, seen at 10 Mpc from 30 deg (through the
# opening) and 80 deg (through the torus)
TORUS = dict(rmin=0.05, rmax=15.0, p=1.0, q=0.0, delta=40.0, tau_v=5.0,
             T=20000.0, L=1e11, lam=(0.1, 3.0), distance_mpc=10.0,
             inclinations=(30, 80))
L_SUN = 3.839e26          # SKIRT's solar luminosity [W]


def torus_number() -> float:
    """The torus's dust entity count for TORUS's equatorial tau_V from the
    centre: its normalised density along +x (the port's TorusGeometry, as
    the loader builds it) integrated on the host over 2 x 10^5 log-spaced
    radii, times the mean interstellar mix's cross section at 0.55
    micron (MeanInterstellarDustMix has no optical-depth normalization in
    the port's loader)."""
    from skirt9_tpu_torch.geometries import axial as gax
    from skirt9_tpu_torch.media import mixes as mx
    t = TORUS
    geom = gax.TorusGeometry(p=t["p"], q=t["q"], delta=math.radians(
        t["delta"]), rmin=t["rmin"] * PC, rmax=t["rmax"] * PC)
    r = np.geomspace(t["rmin"] * PC, t["rmax"] * PC, 200_001)
    pos = np.zeros((len(r), 3))
    pos[:, 0] = r
    col = float(np.trapezoid(geom.density_np(pos), r))
    sig = float(mx.mean_interstellar_approx().at(0.55e-6)[0])
    return t["tau_v"] / (sig * col)


def clump_table(n: int, seed: int = 5, r_lo: float = 0.1,
                r_hi: float = 0.4) -> np.ndarray:
    """n clumps for a ClumpySphericalSpatialGrid, (n, 4): x y z radius in
    pc, drawn from seed: radii uniform in [r_lo, r_hi] pc, centres in the
    torus's wedge (TORUS: within its opening angle of the equator, at
    radii from 0.5 pc to 1 pc inside its outer radius, uniform in volume),
    so that the grid keeps the clumps wholly inside it that overlap no
    clump before them."""
    t = TORUS
    rs = np.random.default_rng(seed)
    rad = rs.uniform(r_lo, r_hi, n)
    r = np.cbrt(rs.uniform(0.5 ** 3, (t["rmax"] - 1.0) ** 3, n))
    lat = np.arcsin(rs.uniform(-1, 1, n) * np.sin(np.radians(t["delta"])))
    phi = rs.uniform(-np.pi, np.pi, n)
    xyz = np.stack([r * np.cos(lat) * np.cos(phi), r * np.cos(lat)
                    * np.sin(phi), r * np.sin(lat)], -1)
    return np.column_stack([xyz, rad])


def clump_file(path, n: int) -> str:
    """clump_table(n) written as a clump file."""
    np.savetxt(str(path), clump_table(n), fmt="%.6f")
    return str(path)


def aimed_source(n: int) -> np.ndarray:
    """An off-centre source position [pc] on the clumpy torus of n clumps:
    0.3 pc before one clump of clump_table(n), on the ray through its
    centre toward the torus's 80-degree instrument (azimuth 0), the clump
    whose ray crosses the most clumps of the table, starts at least 1 pc
    from the centre and leads outward (each shell crossed once, the walk
    well inside the march's 256 steps). Its rays cross shells, cones and
    clumps at an angle; the central source's are radial."""
    inc = math.radians(TORUS["inclinations"][1])
    k = np.array([math.sin(inc), 0.0, math.cos(inc)])
    tab = clump_table(n)
    cen, rad = tab[:, :3], tab[:, 3]
    p0 = cen - (rad + 0.3)[:, None] * k
    rel = cen[None, :, :] - p0[:, None, :]             # (source, clump)
    b = rel @ k
    miss2 = (rel * rel).sum(-1) - b * b
    hits = ((miss2 < rad[None, :] ** 2) & (b > 0)).sum(1)
    ok = (np.linalg.norm(p0, axis=1) >= 1.0) & (p0 @ k >= 0.0)
    return p0[int(np.argmax(np.where(ok, hits, -1)))]


def torus_ski(directory, name: str, nr: int = 100, nt: int = 90,
              npix: int = 64, nlam: int = 40, oligo: bool = False,
              clumps: int = 0, nphi: int = 32, aimed: bool = False) -> str:
    """The torus (TORUS) as a ski file: ExtinctionOnly over 0.1-3 micron
    (OligoExtinctionOnly at 0.55 micron with oligo), a Sphere2DSpatialGrid
    to 15 pc of nr radial (PowMesh, ratio 50) x nt polar (SymPowMesh, ratio
    10) bins, two FullInstruments of npix^2 pixels on nlam log bins. With
    clumps > 0 the grid is a ClumpySphericalSpatialGrid (nphi azimuthal
    bins, from the centre: a grid with an inner hole has no entry from it
    for the central source's packets) with that many clumps of clump_file,
    written beside the ski file; aimed puts the point source off the
    centre, at aimed_source(clumps)."""
    t = TORUS
    x, y, z = aimed_source(clumps) if aimed else (0.0, 0.0, 0.0)
    norm = ('<normalization type="LuminosityNormalization">'
            '<IntegratedLuminosityNormalization wavelengthRange="Source" '
            f'integratedLuminosity="{t["L"]:.6g} Lsun"/></normalization>')
    sed = ('' if oligo else '<sed type="SED"><BlackBodySED temperature='
           f'"{t["T"]} K"/></sed>')
    lo, hi = t["lam"]
    src_sys = ('<SourceSystem wavelengths="0.55 micron" sourceBias="0.5">'
               if oligo else f'<SourceSystem minWavelength="{lo} micron" '
               f'maxWavelength="{hi} micron" sourceBias="0.5">')
    wlg = ('' if oligo else '<defaultWavelengthGrid type="WavelengthGrid">'
           f'<LogWavelengthGrid minWavelength="{lo} micron" maxWavelength='
           f'"{hi} micron" numWavelengths="{nlam}"/></defaultWavelengthGrid>')
    fov = 2.2 * t["rmax"]
    inst = lambda inc: (
        f'<FullInstrument instrumentName="i{inc}" distance='
        f'"{t["distance_mpc"]} Mpc" inclination="{inc} deg" azimuth="0 deg" '
        f'roll="0 deg" fieldOfViewX="{fov} pc" numPixelsX="{npix}" '
        f'centerX="0 pc" fieldOfViewY="{fov} pc" numPixelsY="{npix}" '
        'centerY="0 pc" recordComponents="true" numScatteringLevels="0" '
        'recordPolarization="false" recordStatistics="true"/>')
    mode = "OligoExtinctionOnly" if oligo else "ExtinctionOnly"
    meshes = (f'<meshRadial type="Mesh"><PowMesh numBins="{nr}" ratio="50"/>'
              f'</meshRadial><meshPolar type="Mesh"><SymPowMesh numBins='
              f'"{nt}" ratio="10"/></meshPolar>')
    if clumps:
        clump_file(os.path.join(str(directory), f"{name}_clumps.txt"),
                   clumps)
        grid = (f'<ClumpySphericalSpatialGrid minRadius="0 pc" maxRadius='
                f'"{t["rmax"]} pc" filename="{name}_clumps.txt">{meshes}'
                f'<meshAzimuthal type="Mesh"><LinMesh numBins="{nphi}"/>'
                '</meshAzimuthal></ClumpySphericalSpatialGrid>')
    else:
        grid = (f'<Sphere2DSpatialGrid maxRadius="{t["rmax"]} pc">{meshes}'
                '</Sphere2DSpatialGrid>')
    text = f"""<?xml version='1.0' encoding='UTF-8'?>
<skirt-simulation-hierarchy type="MonteCarloSimulation" format="9" producer="chip_smoke">
  <MonteCarloSimulation userLevel="Expert" simulationMode="{mode}" numPackets="{N_GEO}">
    <random type="Random"><Random seed="0"/></random>
    <units type="Units"><ExtragalacticUnits fluxOutputStyle="Wavelength"/></units>
    <cosmology type="Cosmology"><LocalUniverseCosmology/></cosmology>
    <sourceSystem type="SourceSystem">{src_sys}<sources type="Source"><PointSource positionX="{x:.9g} pc" positionY="{y:.9g} pc" positionZ="{z:.9g} pc" velocityX="0 km/s" velocityY="0 km/s" velocityZ="0 km/s" sourceWeight="1" wavelengthBias="0.5">{sed}{norm}</PointSource></sources></SourceSystem></sourceSystem>
    <mediumSystem type="MediumSystem"><MediumSystem>
      <photonPacketOptions type="PhotonPacketOptions"><PhotonPacketOptions forceScattering="true" minWeightReduction="1e4" minScattEvents="0" pathLengthBias="0.5"/></photonPacketOptions>
      <media type="Medium"><GeometricMedium velocityMagnitude="0 km/s">
        <geometry type="Geometry"><TorusGeometry exponent="{t['p']}" index="{t['q']}" openingAngle="{t['delta']} deg" minRadius="{t['rmin']} pc" maxRadius="{t['rmax']} pc"/></geometry>
        <materialMix type="MaterialMix"><MeanInterstellarDustMix/></materialMix>
        <normalization type="MaterialNormalization"><NumberMaterialNormalization number="{torus_number():.9e}"/></normalization>
      </GeometricMedium></media>
      <grid type="SpatialGrid">{grid}</grid>
    </MediumSystem></mediumSystem>
    <instrumentSystem type="InstrumentSystem"><InstrumentSystem>{wlg}<instruments type="Instrument">{inst(t["inclinations"][0])}{inst(t["inclinations"][1])}</instruments></InstrumentSystem></instrumentSystem>
  </MonteCarloSimulation>
</skirt-simulation-hierarchy>
"""
    path = os.path.join(str(directory), f"{name}.ski")
    with open(path, "w") as f:
        f.write(text)
    return path


# the configurations of this section: (writer, its arguments, run sizes,
# raster_fallback); the full-width ones with their point-source variants
# (a central source at 0.55 micron for the direct-light gate), the reduced
# ones of tests/test_torch_polar.py and tests/test_torch_tetra.py and of
# draw_for_draw_meshes (the galaxies 1000-fold smaller: unit "pc")
_FW = dict(num_packets=N_GEO // 2, batch_size=B_GEO, max_events=24)
_PT = dict(num_packets=1 << 18, batch_size=B_GEO, max_events=24)
_SM = dict(num_packets=2048, batch_size=1024, max_events=6)
_SPH3 = dict(grid="sphere3d", nr=64, nz=64, nphi=64, spiral=True, npix=64)
_CYL3 = dict(grid="cylinder3d", nr=128, nz=64, nphi=64, spiral=True,
             npix=64)
_TET = dict(grid="tetra", spiral=True, npix=64)
# voronoi_density on 3 x 10^4 relaxed sites (with 10^5 its set-up took
# 48-65 s)
_VOR = dict(grid="voronoi", spiral=True, npix=64, relax=True, emission=True,
            sites=30_000,
            rf_bins=25)
_SMALL = dict(npix=16, nlam=12, rf_bins=4, unit="pc")
MESHES = {
    "torus_sphere2d": (torus_ski, {}, dict(_FW, num_packets=N_GEO), True),
    "torus_sphere2d_point": (torus_ski, dict(oligo=True), _PT, True),
    "spiral_sphere3d": (galaxy_ski, _SPH3, _FW, True),
    "spiral_sphere3d_point": (galaxy_ski, dict(_SPH3, sources="point"), _PT,
                              True),
    "spiral_cylinder3d": (galaxy_ski, _CYL3, _FW, True),
    "spiral_cylinder3d_point": (galaxy_ski, dict(_CYL3, sources="point"),
                                _PT, True),
    "tetra_galaxy": (galaxy_ski, _TET, _FW, True),
    "tetra_galaxy_march": (galaxy_ski, _TET, _FW, False),
    "tetra_galaxy_point": (galaxy_ski, dict(_TET, sources="point",
                                            sites=20_000), _PT, False),
    "voronoi_density": (galaxy_ski, _VOR, _FW, True),
    "torus_sphere2d_small": (torus_ski, dict(nr=20, nt=18, npix=16, nlam=12),
                             _SM, True),
    "spiral_sphere3d_small": (galaxy_ski, dict(_SPH3, nr=12, nz=10, nphi=8,
                                               **_SMALL), _SM, True),
    "spiral_cylinder3d_small": (galaxy_ski, dict(_CYL3, nr=12, nz=10, nphi=8,
                                                 **_SMALL), _SM, True),
    "tetra_galaxy_small": (galaxy_ski, dict(_TET, sites=300, **_SMALL), _SM,
                           True),
    "tetra_galaxy_march_small": (galaxy_ski, dict(_TET, sites=300, **_SMALL),
                                 _SM, False),
    "voronoi_density_small": (galaxy_ski, dict(_VOR, sites=300, **dict(
        _SMALL, rf_bins=4)), dict(_SM, max_events=3), True),
    # the torus on the clumpy sphere: 100 x 90 x 32 cells and 1,000 clumps
    # of 0.1-0.4 pc in its wedge (those kept: inside, no overlap), 2^19
    # packets in batches of 2^16; for the direct-light gate one batch of an
    # off-centre source at 0.55 micron (aimed_source: the central source's
    # radial rays stall); reduced for the tests
    "clumpy_torus": (torus_ski, dict(clumps=1000), dict(
        _FW, num_packets=1 << 19), False),
    "clumpy_torus_point": (torus_ski, dict(clumps=1000, oligo=True,
                                           aimed=True),
                           dict(_PT, num_packets=B_GEO), False),
    "clumpy_torus_small": (torus_ski, dict(nr=16, nt=12, nphi=8, npix=16,
                                           nlam=12, clumps=40), _SM, False),
    "clumpy_torus_small_point": (torus_ski, dict(
        nr=16, nt=12, nphi=8, npix=16, clumps=40, oligo=True, aimed=True),
        _SM, False),
}
# the full-width phases profiled (host_per_event): a polar march and the
# tetrahedral raster (the others' loops issue the same operations an event
# as one of these, PERF.md section 5)
BREAKDOWN_OF = ("torus_sphere2d", "tetra_galaxy")
# a full-width configuration's central point source on the same grid (the
# direct-light gate of an exact walk; the tetrahedral one on a mesh of
# 2 x 10^4 sites, whose build is five times quicker)
POINT_OF = {"torus_sphere2d": "torus_sphere2d_point",
            "spiral_sphere3d": "spiral_sphere3d_point",
            "spiral_cylinder3d": "spiral_cylinder3d_point",
            "tetra_galaxy_march": "tetra_galaxy_point"}
# the CPU-against-card bounds of tests/test_torch_cuda.py's
# test_march_on_cuda_matches_cpu beyond MARCH_BOUNDS: the launch and
# scattering directions are the same bits on both (xlamath.sincos), but
# PyTorch's CPU and CUDA log and exp part by an ulp here and there, and
# that moves an interaction point; the 3D sphere's small polar cells
# amplify a moved scattering in its RF per cell (measured on the card 8.6e-4,
# 1.4e-2 before the directions were exact; the torus's scattered SED 9.2e-7,
# 4.0e-5 before), and on the clumpy sphere a ray that grazes a clump or
# stalls on a radial ray (ROADMAP.md queue C) turns on the last ulp of its
# start (its scattered SED 1.9e-2)
MESH_BOUNDS = {"spiral_sphere3d_small": {"rf": 2e-3},
               "clumpy_torus_small": {"sed2": 5e-2}}
# draw_for_draw_meshes: a raster with dust emission (kernels 4-5 CPU
# against card) and march_tetra; the polar marches' and the tetrahedral
# raster's CPU-against-card runs are tests/test_torch_cuda.py's
# (test_march_on_cuda_matches_cpu, test_polar_and_tetra_loops_...)
MESH_DRAW = ("tetra_galaxy_march_small", "voronoi_density_small")


def mesh_ski(name: str, directory, **over) -> str:
    """The ski file of MESHES[name] (its arguments updated by over),
    written into directory (a _march variant shares its ski file)."""
    write, kw, _, _ = MESHES[name]
    return write(directory, name.replace("_march", ""), **dict(kw, **over))


def mesh_config(name: str, device, directory, **run):
    """MESHES[name] through the port's load_ski at its run sizes (updated
    by run); the _march variants and the tetrahedral point source with
    raster_fallback off (the exact walk, march_tetra)."""
    import dataclasses
    from skirt9_tpu_torch.config.ski import load_ski
    _, _, sizes, raster = MESHES[name]
    sim = load_ski(mesh_ski(name, directory), device=device,
                   **dict(sizes, **run))
    if not raster:
        sim = dataclasses.replace(sim, options=dataclasses.replace(
            sim.options, raster_fallback=False))
    return sim


def walk_tau(sim, lam: float = 0.55e-6, inst: int = 0) -> float:
    """The optical depth at lam from the simulation's point source toward
    instrument inst through the grid's cells, in f64 on the host from the
    cells' geometry and the medium's densities: on a 2D or 3D sphere (a
    central source) the radial ray's shells in the polar (and azimuthal)
    bin of the direction (atan2 in f64); on the 3D cylinder (a central
    source, a face-on direction) the z slabs above the origin in the
    innermost annulus's wedge of azimuth 0; on a tetrahedral mesh (a
    central source) each tetrahedron's chord, the ray's interval inside
    its four face planes; on the clumpy sphere, from any source inside it,
    the ray cut at every crossing of a shell, a polar cone, an azimuthal
    half-plane and a clump, each piece in the cell that holds its middle
    (the clumps first, as the grid's locate)."""
    import torch
    from skirt9_tpu_torch.media import system as msys
    host = lambda t: t.detach().double().cpu().numpy()
    k = host(sim._inst_tabs[inst]["kobs"])
    sig = host(msys.optics_at(sim.medium, torch.tensor(
        [lam], dtype=torch.float32, device=sim.device)).sigma_ext)[0]
    kappa = host(sim.medium.nd) @ sig
    g = sim.grid
    name = type(g).__name__
    p0 = np.asarray(sim.sources[0].position, np.float64)
    bin_of = lambda b, v: np.clip(np.searchsorted(host(b), v, "right") - 1,
                                  0, len(b) - 2)
    if name == "ClumpySphericalGrid":
        sph, nc = g.sph, g.n_clumps
        cen, rad = host(g.ccen), host(g.crad)
        rb, tb, pb = host(sph.rb), host(sph.tb), host(sph.pb)

        def roots(a, b, c):
            """The real roots of a t^2 + b t + c (or b t + c)."""
            if a == 0.0:
                return [-c / b] if b != 0.0 else []
            d = b * b - 4 * a * c
            if d < 0:
                return []
            q = -0.5 * (b + math.copysign(math.sqrt(d), b))
            return [q / a] + ([c / q] if q != 0.0 else [])

        pk, pp = float(p0 @ k), float(p0 @ p0)
        t_end = -pk + math.sqrt(pk * pk - (pp - rb[-1] ** 2))
        ts = [0.0, t_end]
        for r in rb:
            ts += roots(1.0, 2 * pk, pp - r * r)
        for th in tb:
            c2 = math.cos(th) ** 2
            ts += roots(k[2] ** 2 - c2, 2 * (p0[2] * k[2] - c2 * pk),
                        p0[2] ** 2 - c2 * pp)
        for ph in pb:
            ts += roots(0.0, math.sin(ph) * k[0] - math.cos(ph) * k[1],
                        math.sin(ph) * p0[0] - math.cos(ph) * p0[1])
        rel = cen - p0
        b = rel @ k
        sq = np.sqrt(np.clip(b * b - ((rel * rel).sum(1) - rad * rad), 0.0,
                             None))
        ts += list(b - sq) + list(b + sq)
        ts = np.unique(np.clip(np.asarray(ts), 0.0, t_end))
        mid = 0.5 * (ts[1:] + ts[:-1])
        pts = p0 + mid[:, None] * k
        inside = ((pts[:, None, :] - cen[None]) ** 2).sum(-1) < rad ** 2
        r = np.linalg.norm(pts, axis=1)
        cells = nc + (bin_of(sph.rb, r) * sph.nt + bin_of(
            sph.tb, np.arctan2(np.hypot(pts[:, 0], pts[:, 1]), pts[:, 2]))) \
            * sph.nphi + bin_of(sph.pb, np.arctan2(pts[:, 1], pts[:, 0]))
        cells = np.where(inside.any(1), inside.argmax(1), cells)
        return float((np.diff(ts) * kappa[cells]).sum())
    require(not p0.any(), f"walk_tau: a central source on {name}")
    if name == "TetraGrid":
        n, d = host(g.face_n), host(g.face_d)            # (N, 4, 3), (N, 4)
        kn = n @ k                                       # (N, 4)
        t = np.where(np.abs(kn) > 0, -d / np.where(kn == 0, 1, kn), 0.0)
        t_in = np.max(np.where(kn < 0, t, 0.0), axis=1)
        t_out = np.min(np.where(kn > 0, t, np.inf), axis=1)
        outside = np.any((kn == 0) & (d > 0), axis=1)
        return float((np.where(outside, 0.0, np.clip(t_out - t_in, 0, None))
                      * kappa).sum())
    phi = math.atan2(k[1], k[0])
    if name == "Cylinder3DGrid":
        require(abs(k[2]) == 1.0, "walk_tau: a face-on cylinder")
        zb = host(g.zb)
        ip = bin_of(g.pb, phi)
        z0 = np.clip(zb[:-1], 0.0, None) if k[2] > 0 else \
            np.clip(-zb[1:], 0.0, None)
        z1 = np.clip(zb[1:], 0.0, None) if k[2] > 0 else \
            np.clip(-zb[:-1], 0.0, None)
        cells = (0 * g.nphi + ip) * g.nz + np.arange(g.nz)
        return float(((z1 - z0) * kappa[cells]).sum())
    rb = host(g.rb)
    it = bin_of(g.tb, math.atan2(math.hypot(k[0], k[1]), k[2]))
    cells = np.arange(g.nr) * g.nt + it
    if name == "Sphere3DGrid":
        cells = cells * g.nphi + bin_of(g.pb, phi)
    return float((np.diff(rb) * kappa[cells]).sum())


def mass_gate(sim, number: float, bound: float, what: str) -> dict:
    """The dust entities on the grid (per-cell density times volume, f64)
    against the normalization's number, within bound: the reference's
    own deviation at the same set-up (cell-averaged densities on cones,
    wedges and tetrahedra are approximate in the reference too)."""
    n_grid = float((sim.medium.nd[:, 0].double().cpu().numpy()
                    * sim.grid.volumes()).sum())
    e = abs(n_grid / number - 1)
    require(e <= bound, f"{what}: dust entities on the grid within {bound} "
            f"of the normalization ({e})")
    return dict(dust_entities=n_grid, number=number, mass_rel_err=e,
                mass_bound=bound)


# the bound of the mass gate: the reference's deviation of the dust on the
# grid from the normalization at each full-width set-up, measured on the
# CPU (its load_ski; PERF.md section 4), rounded up in the third digit:
# +1.92%, -7.47%, -6.76%, -4.45%, +2.41% (the galaxy's dust past 25 kpc
# is off the grid; cell-averaged densities on cones, tetrahedra and
# Voronoi cells: -0.236% on 10^5 relaxed sites, +2.41% on 3 x 10^4)
MASS_BOUNDS = {"torus_sphere2d": 0.0193, "spiral_sphere3d": 0.0748,
               "spiral_cylinder3d": 0.0676, "tetra_galaxy": 0.0446,
               "voronoi_density": 0.0242}


# the configurations loaded on the card, with their set-up seconds: the
# kernel phases and the full-width phases share them (a Voronoi mesh of
# 10^5 relaxed sites takes a minute of host work)
_MESH_SIMS: dict = {}


def _mesh_sim(name):
    """MESHES[name] on the card, loaded once per run; (sim, set-up s). A
    _march variant is its configuration with raster_fallback off, made
    from the loaded one: the same grid, medium and sources, without the
    raster's tables, so that it marches (as `bridge.simulation(...,
    march=True)` makes a march of a rasterized configuration)."""
    import copy
    import dataclasses
    if name not in _MESH_SIMS:
        t0 = time.perf_counter()
        if name.endswith("_march"):
            base, setup = _mesh_sim(name[:-len("_march")])
            t0 = time.perf_counter()
            sim = copy.copy(base)
            sim.options = dataclasses.replace(base.options,
                                              raster_fallback=False)
            sim._sweep_tabs = None
            _MESH_SIMS[name] = (sim, setup + time.perf_counter() - t0)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                _MESH_SIMS[name] = (mesh_config(name, "cuda", tmp),
                                    time.perf_counter() - t0)
    return _MESH_SIMS[name]


def phase_kernels_march_polar(torch) -> dict:
    """The march kernel's polar modes against their plain versions, cells
    and lengths bit for bit (_march_check): march_sphere2d at
    torus_sphere2d's first event (2^16 lanes, 100 x 90 cells, S = 256),
    march_sphere3d at spiral_sphere3d's (64^3 cells to 25 kpc, shift 10)
    and march_cylinder3d at spiral_cylinder3d's (128 x 64 x 64). Seeded
    rays through each mode's grids, staged and unstaged, at pc and kpc
    scale: tests/test_torch_cuda.py's test_march_kernel."""
    out = {}
    for name, mode in (("torus_sphere2d", "march_sphere2d"),
                       ("spiral_sphere3d", "march_sphere3d"),
                       ("spiral_cylinder3d", "march_cylinder3d")):
        sim, _ = _mesh_sim(name)
        S = sim.options.max_steps
        pos, dirn, cell, alive = _first_event_lanes(torch, sim, B_GEO)
        out[mode] = dict(_march_check(torch, mode, sim.grid, pos, dirn,
                                      cell, S, alive),
                         cells=sim.grid.ncells, shift=sim.grid.shift)
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    emit({"phase": "kernels_march_polar", **out})
    return out


def phase_kernels_march_tetra(torch) -> dict:
    """march_tetra at tetra_galaxy_march's first event (2^16 lanes, about
    6.5 x 10^5 tetrahedra of 10^5 density-sampled sites) and on seeded rays
    through a 300-site mesh, bit for bit (_march_check); kernels 4-5 at
    the tetrahedral raster (tetra_galaxy) and at the relaxed Voronoi
    raster (voronoi_density, 25 RF rows) first events against their plain
    versions (_kernel4_b4, _kernel5_grouped)."""
    from skirt9_tpu_torch.grids import tetra
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.transport import mlsweep as ml
    out = {}
    sim, setup = _mesh_sim("tetra_galaxy_march")
    require(sim._sweep_tabs is None, "tetra_galaxy_march walks exactly")
    pos, dirn, cell, alive = _first_event_lanes(torch, sim, B_GEO)
    out["march_tetra"] = dict(_march_check(
        torch, "march_tetra", sim.grid, pos, dirn, cell,
        sim.options.max_steps, alive), cells=sim.grid.ncells,
        setup_s=setup, walk_steps=sim.grid.walk_steps)
    dev = sim.device
    rs = np.random.default_rng(41)
    small = tetra.build_tetra(rs.uniform(-PC, PC, (300, 3)),
                              ((-PC, PC),) * 3).to(dev)
    p = torch.tensor(rs.uniform(-1.5 * PC, 1.5 * PC, (B_GEO, 3)).astype(
        np.float32), device=dev)
    d = rs.normal(size=(B_GEO, 3))
    d = torch.tensor((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32), device=dev)
    p, c, _ = small.move_inside(p, d)
    out["march_tetra_300"] = _march_check(
        torch, "march_tetra", small, p, d, c, small.max_steps(), c >= 0)
    del pos, dirn, cell, alive
    torch.cuda.empty_cache()
    for name in ("tetra_galaxy", "voronoi_density"):
        sim, setup = _mesh_sim(name)
        tabs = sim._sweep_tabs
        require(isinstance(tabs, ml.MLTables), f"{name} on its raster")
        pkt, opts, pre = first_event_b3(torch, sim)
        sig = msys.optics_at(sim.medium, pkt.lam).sigma_ext.T.contiguous()
        res = _kernel4_b4(torch, sim, pkt, sig, f"{name}'s raster")
        res["mlsweep_deposit"] = _kernel5_grouped(
            torch, sim, pkt, opts, pre, f"kernel 5 on {name}'s raster")
        out[name] = dict(res, cells=sim.grid.ncells, raster=list(tabs.n),
                         setup_s=setup)
        del pkt, pre
        torch.cuda.empty_cache()
    emit({"phase": "kernels_march_tetra", **out})
    return out


def phase_draw_for_draw_meshes(torch) -> dict:
    """MESH_DRAW on the CPU (plain versions) and on the card (kernels),
    the same seed: march_gaps within MARCH_BOUNDS; each case's march mode
    (or kernels 4-5 on a raster) and detect launched, no other march mode
    or sweep."""
    res, launches = {}, {}
    every = SWEEPS + MARCH + MARCH_TREE + MARCH_CURVI + MARCH_AMR \
        + MARCH_POLAR + MARCH_TETRA
    with tempfile.TemporaryDirectory() as tmp:
        for name in MESH_DRAW:
            outs = {}
            for device in ("cpu", "cuda"):
                sim = mesh_config(name, device, tmp)
                dust = sim.ems_borders is not None
                run = (lambda: sim.run_with_dust_emission(verbose=False)) \
                    if dust else (lambda: sim.run_primary(verbose=False))
                if device == "cuda":
                    must = ML if sim._sweep_tabs is not None else (
                        MODES_OF[type(sim.grid).__name__],)
                    outs[device], n = drive(must + DETECT, tuple(
                        k for k in every if k not in must), run)
                    launches[name] = {k: v for k, v in n.items() if v}
                else:
                    outs[device] = run()
            res[name] = march_gaps(outs["cpu"], outs["cuda"], dust,
                                   MESH_BOUNDS.get(name))
            torch.cuda.empty_cache()
    emit({"phase": "draw_for_draw_meshes", "march_bounds": MARCH_BOUNDS,
          "mesh_bounds": MESH_BOUNDS,
          "gaps": res, "launches": launches})
    return launches


def torus_gates(sim, sed_um, n_sigma: float = 5.0) -> dict:
    """The torus's transparent SED against its blackbody (point_source_gates'
    transparent part with TORUS's source, seen at 10 Mpc)."""
    t = TORUS
    src = dict(L=t["L"] * L_SUN, T=t["T"], lo=t["lam"][0] * 1e-6,
               hi=t["lam"][1] * 1e-6, bias=0.5,
               d=t["distance_mpc"] * 1e6 * 3.08567758149e16)
    return point_source_gates(sim, sed_um, n_sigma, src=src, direct=False)


def phase_full_width_mesh(torch, smi: str, name: str) -> dict:
    """One configuration of MESHES at full width, timed after a one-batch
    warm-up: its march mode (or kernels 4-5 on a raster) and detect
    launched, no other. Gates: the transparent SED against the sources'
    blackbodies (torus_gates, blackbody_mix_gates), R < 0.01 in the bins
    above 1% of the peak, the dust on the grid against the normalization
    (mass_gate); on the exact walks the direct light of a central source
    (on the clumpy sphere an off-centre one) at 0.55 micron against
    exp(-tau) through the cells (walk_tau, direct_gate; the torus at 80
    deg); on a tetrahedral mesh the cell
    volumes tiling the box (1e-6); with dust emission L_dust = L_abs_primary
    (1e-4). One batch profiled (host_per_event)."""
    from skirt9_tpu_torch.transport import march as mr
    raster = MESHES[name][3]
    sim, setup = _mesh_sim(name)
    dust = sim.ems_borders is not None
    mode = mr.MODES[type(sim.grid)]
    rasterized = sim._sweep_tabs is not None
    require(rasterized == (raster and mode in ("march_tetra",
                                               "march_voronoi")),
            f"{name}'s engine")
    must = ML if rasterized else (mode,)
    res = {"phase": f"full_width_{name}", "cells": sim.grid.ncells,
           "setup_s": setup, "max_steps": sim.options.max_steps}
    if sim._sweep_tabs is not None:
        res["raster"] = list(sim._sweep_tabs.n)
    if mode == "march_clumpy":
        # the central source's ray toward the 80-degree instrument: the
        # cells' geometry against the step's own walk, which stalls
        # (ROADMAP.md queue C); the direct-light gates are the off-centre
        # point source's (POINT_OF, clumpy_direct)
        tau_m, reach = march_tau(sim, inst=1)
        res.update(clumps_retained=sim.grid.n_clumps, central_ray_i80=dict(
            geometric_tau=walk_tau(sim, inst=1), march_tau=tau_m,
            march_reach=reach))
    base = name.replace("_march", "")
    torus = "torus" in base
    number = torus_number() if torus else \
        dust_disk_number(MESHES[name][1].get("unit", "kpc"))
    res.update(mass_gate(sim, number, MASS_BOUNDS[base], name))
    if mode == "march_tetra":
        vt = float(sim.grid.volumes().sum())
        lo, hi = (sim.grid.box_lo.double().cpu().numpy(),
                  sim.grid.box_hi.double().cpu().numpy())
        e = abs(vt / float(np.prod(hi - lo)) - 1)
        require(e <= 1e-6, f"{name}: tetrahedra tile the box ({e})")
        res["volume_tiling_err"] = e
    n_full = sim.num_packets
    one_batch(sim, sim.run_with_dust_emission if dust
              else sim.run_primary)                  # warm-up
    out, launches, dt = _run_phase(torch, sim, must, dust)
    rf, accs = out[0], out[1]
    res.update(packets=sim.num_packets, batch=sim.batch_size, seconds=dt,
               packets_per_s=sim.num_packets / dt,
               events=sim.last_stats.get("events"),
               launches={k: v for k, v in launches.items() if v})
    with tempfile.TemporaryDirectory() as tmp:
        paths = [p for p in sim.write_outputs(accs, name, tmp)
                 if p.endswith("_sed.dat")]
        cols = [np.loadtxt(p) for p in paths]
    if torus:
        res.update(torus_gates(sim, {"transparent": cols[0][:, 2]}))
    else:
        res.update(blackbody_mix_gates(sim, {"transparent": cols[0][:, 2]}))
    lit = cols[0][:, 1] > 1e-2 * cols[0][:, 1].max()
    R = cols[0][lit, 7]
    require(float(R.max()) < 0.01, f"{name}: SED relative error R {R.max()}")
    res["R_max"] = float(R.max())
    res["direct_over_transparent"] = [
        float(c[lit, 3].sum() / c[lit, 2].sum()) for c in cols]
    if dust:
        info = out[2]
        e_l = abs(info["L_dust"] / info["L_abs_primary"] - 1)
        require(e_l <= 1e-4, f"{name}: L_dust / L_abs_primary - 1 {e_l}")
        res.update(iterations=info["iterations"], L_dust=info["L_dust"],
                   L_abs_primary=info["L_abs_primary"], L_dust_rel_err=e_l)
    pt = POINT_OF.get(name)
    if pt is not None:
        psim, _ = _mesh_sim(pt)
        res["point_source"] = direct_gate(
            torch, psim, pt, inst=1 if torus else 0)
        del _MESH_SIMS[pt], psim
    if name in BREAKDOWN_OF:
        sim.num_packets = sim.batch_size
        res["breakdown"] = host_per_event(
            torch, sim, (lambda s: s.run_with_dust_emission(verbose=False))
            if dust else (lambda s: s.run_primary(verbose=False)), warm=True)
        sim.num_packets = n_full
    del sim
    torch.cuda.empty_cache()
    emit(dict(res, device=torch.cuda.get_device_name(0), nvidia_smi=smi))
    return launches, res.get("point_source", {}).get("launch_counts")


# ----------------------------------------------- the clumpy sphere, DP
# The torus on a ClumpySphericalSpatialGrid (the march kernel's mode
# march_clumpy: a Sphere3D step plus a loop over the clump table), the
# Ivezic shell with dust emission on the 1D sphere, and packet data
# parallelism (parallel/dp.py) through the CLI and two ranks on one card.
MARCH_CLUMPY = ("march_clumpy",)
# f32 operations per walked (step, lane): march_sphere3d's step and
# relocation, and per clump its crossing (the offset, two fused dot
# products, the discriminant, the root, both roots, the tests: 20) and in
# the relocation its point test (8)
OPS_MARCH.update(march_clumpy=OPS_MARCH["march_sphere3d"])
OPS_CLUMP = 28
MODES_OF.update(ClumpySphericalGrid="march_clumpy")
POINT_OF["clumpy_torus"] = "clumpy_torus_point"
# the reference's deviation of the dust on the clumpy torus's grid from the
# normalization (tests/reference_mass.py: -0.409237%, rounded up in the third
# digit)
MASS_BOUNDS["clumpy_torus"] = 0.00410


def phase_kernels_sincos(torch) -> dict:
    """glibc's sinf and cosf (csrc/sincos.cu) against the plain version
    (ops/xlamath.py `sincos_plain`) on the same CUDA tensor, bit for bit:
    config 1's launch azimuths (2^17 lanes, 2 pi times a uniform) with the
    edge values of every branch and arguments past 120. Timed by CUDA
    events and the profiler; the bound from its bytes (4 in, 8 out a
    value; its ~40 f64 operations a value have no rate in the H100's
    table of peak rates). Then the HG scattering direction (csrc/sincos.cu
    hg_direction) against ops/phase.py `hg_scatter_plain` at config 1's
    batch, bit for bit, timed alike; last the interaction depth and the
    deposit factor in XLA's math (csrc/xla_math.cu, check_xla_math)."""
    from skirt9_tpu_torch.kernels import build as kb
    from skirt9_tpu_torch.ops import xlamath as xm
    rs = np.random.default_rng(47)
    edges = np.array([0.0, -0.0, 1e-40, 2.0 ** -12, 0.75, 119.99, 120.0,
                      -3 * math.pi, 1e6], np.float32)
    x = torch.tensor(np.concatenate([
        (rs.random(B_FULL) * 2 * math.pi).astype(np.float32), edges]),
        device="cuda")
    kb.reset_launches()
    s, c = xm.sincos(x)
    require(kb.LAUNCHES["sincos"] == 1, "sincos launched once")
    ps, pc = xm.sincos_plain(x)
    same = bool(torch.equal(s.view(torch.int32), ps.view(torch.int32))
                and torch.equal(c.view(torch.int32), pc.view(torch.int32)))
    require(same, "sincos bit for bit its plain version")
    kern = lambda: xm.sincos(x)
    dev = device_ms(kern)
    out = {"sincos": dict(
        max_abs_err=float(max((s - ps).abs().max(), (c - pc).abs().max())),
        lanes=x.numel(), ms=cuda_ms(kern), device_ms=dev["ours"] or None,
        profiler_dropped=dev["ours"] == 0, plain_ms=cuda_ms(
            lambda: xm.sincos_plain(x), reps=5),
        plain_device_launches=device_ms(lambda: xm.sincos_plain(x),
                                        reps=3)["launches"],
        library_ms=None, **bound(12 * x.numel(), 0.0))}
    # the HG scattering direction at config 1's batch: seeded unit
    # directions, asymmetries and uniforms
    from skirt9_tpu_torch.ops import phase as phs
    k = rs.normal(size=(B_FULL, 3))
    k = (k / np.linalg.norm(k, axis=1, keepdims=True)).astype(np.float32)
    args = [torch.tensor(a, device="cuda") for a in (
        k, rs.uniform(-0.99, 0.99, B_FULL).astype(np.float32),
        rs.random(B_FULL).astype(np.float32),
        rs.random(B_FULL).astype(np.float32))]
    kb.reset_launches()
    d = phs.hg_scatter(*args)
    require(kb.LAUNCHES["hg_direction"] == 1, "hg_direction launched once")
    pd = phs.hg_scatter_plain(*args)
    require(torch.equal(d.view(torch.int32), pd.view(torch.int32)),
            "hg_direction bit for bit its plain version")
    kern = lambda: phs.hg_scatter(*args)
    dev = device_ms(kern)
    # 24 bytes in and 12 out a lane; 53 f32 operations a lane beside the
    # sine and cosine's f64 ones
    out["hg_direction"] = dict(
        max_abs_err=float((d - pd).abs().max()), lanes=B_FULL,
        ms=cuda_ms(kern), device_ms=dev["ours"] or None,
        profiler_dropped=dev["ours"] == 0,
        plain_ms=cuda_ms(lambda: phs.hg_scatter_plain(*args), reps=5),
        plain_device_launches=device_ms(
            lambda: phs.hg_scatter_plain(*args), reps=3)["launches"],
        library_ms=None, **bound(36 * B_FULL, 53 * B_FULL))
    out.update(check_xla_math(torch, rs))
    emit({"phase": "kernels_sincos", **out})
    return out


def check_xla_math(torch, rs) -> dict:
    """XLA's exp, expm1, log and log1p (csrc/xla_math.cu) against their
    plain versions on the same CUDA tensors, bit for bit: the interaction
    depth (`lifecycle.sample_interaction_tau`, forced scattering with xi
    0.5 and 0, and a plain free path) at config 1's batch, path depths from
    1e-8 to 1e3 with the edges 0, 1e-6 and 1/2; the deposit factor
    (`march.deposit_factor`) on a march's (99, 2^17) steps, a tenth empty.
    Timed alike; the bounds from their bytes and the f32 operations of
    their float replays (their f64 multiply-adds have no rate in the
    table)."""
    from skirt9_tpu_torch.kernels import build as kb
    from skirt9_tpu_torch.transport import lifecycle as lc
    from skirt9_tpu_torch.transport import march as mr
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32), device="cuda")
    tau = np.concatenate([10 ** rs.uniform(-8, 3, B_FULL - 4),
                          [0.0, 1e-6, 0.5, 1e-30]])
    tau_path = t32(tau)
    u = {t: t32(rs.uniform(1e-7, 1.0, B_FULL)) for t in (
        lc._TAG_PATH_CHOICE, lc._TAG_PATH_TAU_UNI, lc._TAG_PATH_TAU_EXP)}
    for forced, xi in ((True, 0.0), (False, 0.5), (True, 0.5)):
        opts = lc.TransportOptions(max_steps=1, force_scattering=forced,
                                   path_length_bias=xi)
        kb.reset_launches()
        got = lc.sample_interaction_tau(opts, u, tau_path)
        require(kb.LAUNCHES["interaction_depth"] == 1
                and sum(kb.LAUNCHES.values()) == 1,
                "interaction_depth launched once")
        want = lc.sample_interaction_tau_plain(opts, u, tau_path)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"interaction_depth bit for bit its plain version "
                f"(forced {forced}, xi {xi})")
    kern = lambda: lc.sample_interaction_tau(opts, u, tau_path)
    plain = lambda: lc.sample_interaction_tau_plain(opts, u, tau_path)
    dev = device_ms(kern)
    out = {"interaction_depth": dict(
        max_abs_err=0.0, lanes=B_FULL, ms=cuda_ms(kern),
        device_ms=dev["ours"] or None, profiler_dropped=dev["ours"] == 0,
        plain_ms=cuda_ms(plain, reps=5),
        plain_device_launches=device_ms(plain, reps=3)["launches"],
        library_ms=None, **bound(25 * B_FULL, 120 * B_FULL))}
    S = 99
    ds = t32(rs.uniform(0.0, 1e16, (S, B_FULL)))
    dtau = t32(10 ** rs.uniform(-9, 1, (S, B_FULL)))
    ds[:S // 10] = 0.0
    kb.reset_launches()
    got = mr.deposit_factor(ds, dtau)
    require(kb.LAUNCHES["deposit_factor"] == 1, "deposit_factor launched")
    require(torch.equal(got, mr.deposit_factor_plain(ds, dtau)),
            "deposit_factor bit for bit its plain version")
    kern = lambda: mr.deposit_factor(ds, dtau)
    plain = lambda: mr.deposit_factor_plain(ds, dtau)
    dev = device_ms(kern)
    out["deposit_factor"] = dict(
        max_abs_err=0.0, steps=S, lanes=B_FULL, ms=cuda_ms(kern),
        device_ms=dev["ours"] or None, profiler_dropped=dev["ours"] == 0,
        plain_ms=cuda_ms(plain, reps=3),
        plain_device_launches=device_ms(plain, reps=3)["launches"],
        library_ms=None, **bound(12 * S * B_FULL, 45 * S * B_FULL))
    return out


def phase_kernels_march_clumpy(torch) -> dict:
    """march_clumpy against its plain version, cells and lengths bit for
    bit (_march_check): at clumpy_torus's first event (2^14 lanes, 100 x 90
    x 32 cells and its retained clumps, staged in shared memory beside the
    sphere's tables: its central source's radial rays, most of which
    stall, ROADMAP.md queue C), on the first 2^13 of 2^16 isotropic rays
    from the off-centre aimed_source on the same grid (oblique to the
    shells; the kernel timed on all 2^16, its bound from the kernel's own
    walk, bit for bit with the plain version's where both ran), and on 64
    steps of seeded rays through a sphere with ~6,000 clumps (past 48 KB:
    the clumps through the read-only cache)."""
    from skirt9_tpu_torch.grids import clumpy
    from skirt9_tpu_torch.transport import march as mr
    sim, setup = _mesh_sim("clumpy_torus")
    S = sim.options.max_steps
    pos, dirn, cell, alive = _first_event_lanes(torch, sim, 1 << 14)
    out = {"march_clumpy": dict(_march_check(
        torch, "march_clumpy", sim.grid, pos, dirn, cell, S, alive),
        cells=sim.grid.ncells, shift=sim.grid.shift, setup_s=setup)}
    del pos, dirn, cell, alive
    t32 = lambda a: torch.tensor(np.asarray(a, np.float32),
                                 device=sim.device)
    d = np.random.default_rng(44).normal(size=(B_GEO, 3))
    d = t32(d / np.linalg.norm(d, axis=1, keepdims=True))
    p = t32(np.repeat(aimed_source(1000)[None] * PC, B_GEO, axis=0))
    c = sim.grid.locate(p)
    n = 1 << 13
    aimed = _march_check(torch, "march_clumpy", sim.grid, p[:n], d[:n],
                         c[:n], S, c[:n] >= 0)
    kern = lambda: mr._march_cuda(sim.grid, p, d, c, S, c >= 0)
    ck, dk = kern()
    walked = dk > 0
    tables, ops, _ = march_cost("march_clumpy", sim.grid, ck, walked)
    dev = device_ms(kern)
    out["march_clumpy_aimed"] = dict(
        aimed, source_pc=aimed_source(1000).tolist(), lanes_timed=B_GEO,
        ms_timed=cuda_ms(kern, reps=5), device_ms_timed=dev["ours"] or None,
        live_share_timed=float(walked.float().mean()),
        max_walk_timed=int(walked.sum(dim=0).max()),
        bound_timed=bound(S * B_GEO * 8 + B_GEO * 29 + tables, ops))
    del p, d, c, ck, dk, walked
    rs = np.random.default_rng(43)
    R = TORUS["rmax"] * PC
    cen = rs.uniform(-0.85 * R, 0.85 * R, (6000, 3))
    g = clumpy.make_clumpy_spherical(R, 40, 24, 16, cen,
                                     rs.uniform(0.004, 0.008, 6000) * R,
                                     overlap_samples=200,
                                     device=sim.device).to(sim.device)
    require(4 * g.n_clumps > 12 * 1024, "the clump table past 48 KB")
    B = 1 << 11
    d = rs.normal(size=(B, 3))
    p, c, _ = g.move_inside(t32(rs.uniform(-1.2 * R, 1.2 * R, (B, 3))),
                            t32(d / np.linalg.norm(d, axis=1, keepdims=True)))
    d = t32(d / np.linalg.norm(d, axis=1, keepdims=True))
    out["march_clumpy_global"] = dict(_march_check(
        torch, "march_clumpy", g, p, d, c, 64, c >= 0), clumps=g.n_clumps)
    torch.cuda.empty_cache()
    emit({"phase": "kernels_march_clumpy", **out})
    return out


def phase_full_width_ivezic_dust(torch, smi: str) -> dict:
    """The Ivezic shell with dust emission (ivezic_dust: 40 shells, a
    25-bin RF, 25 emission bins) on the 1D sphere at 2^19 packets in
    batches of 2^16, timed after a one-batch warm-up: march_sphere1d and
    detect launched, no other; gated: L_dust = L_abs_primary within 1e-4,
    the secondary light lit, R < 0.01 where the SED is lit."""
    with tempfile.TemporaryDirectory() as tmp:
        sim = geometric_config("ivezic_dust", "cuda", tmp,
                               num_packets=1 << 19)
        require(sim.ems_borders is not None and sim._sweep_tabs is None,
                "ivezic_dust: dust emission on the march")
        n_full = sim.num_packets
        sim.num_packets = sim.batch_size
        sim.run_with_dust_emission(verbose=False)
        sim.num_packets = n_full
        out, launches, dt = _run_phase(torch, sim, ("march_sphere1d",), True)
        rf, accs, info = out
        e = abs(info["L_dust"] / info["L_abs_primary"] - 1)
        require(e <= 1e-4, f"ivezic_dust: L_dust / L_abs_primary - 1 {e}")
        paths = [p for p in sim.write_outputs(accs, "ivezic_dust", tmp)
                 if p.endswith("_sed.dat")]
        cols = np.loadtxt(paths[0])
    lit = cols[:, 1] > 1e-2 * cols[:, 1].max()
    require(float(cols[lit, 7].max()) < 0.01, "ivezic_dust: SED R < 0.01")
    from skirt9_tpu_torch.instruments import distant as dinst
    sec = float(accs[0]["sed"][dinst.KIND_SECONDARY_DIRECT].sum())
    require(sec > 0, "ivezic_dust: the secondary light reaches i0")
    res = {"phase": "full_width_ivezic_dust", "cells": sim.grid.ncells,
           "packets": n_full, "batch": sim.batch_size, "seconds": dt,
           "packets_per_s": n_full / dt,
           "segments": [x[0] for x in sim.last_stats["segments"]],
           "launches": {k: v for k, v in launches.items() if v},
           "L_dust": info["L_dust"], "L_abs_primary": info["L_abs_primary"],
           "L_dust_rel_err": e, "R_max": float(cols[lit, 7].max()),
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    del sim
    torch.cuda.empty_cache()
    emit(res)
    return launches


def _dp_rank(group, out: str, n_packets: int) -> None:
    """One rank of phase_dp's two-rank run: config 1 at full width on the
    rank's device, its histories shared with the other rank; rank 0 saves
    the accumulators and the ranks' seconds."""
    import torch
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "skirt9_tpu"))
    require(not bad, f"rank {group.rank} imported {bad[:3]}")
    sim = config1(group.device, num_packets=n_packets)
    sim.group = group
    sim.num_packets = sim.batch_size * group.size
    sim.run_primary(verbose=False)                    # warm-up
    sim.num_packets = n_packets
    torch.cuda.synchronize()
    group.barrier()
    t0 = time.perf_counter()
    _, accs = sim.run_primary(verbose=False)
    torch.cuda.synchronize()
    dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
    group.all_reduce([dt])                              # the ranks' sum
    if group.writes:
        np.savez(out, seconds=float(dt) / group.size,
                 **{k: v.cpu().numpy() for k, v in accs[0].items()})


# -d 1 against the CLI run without -d: the bounds on each file's largest
# gap (per SED column and over the FITS frame, relative to its maximum),
# from the spread between two runs without -d on the card (measured on an
# H100: the SED 1.0e-16, the frame 2.7e-9, and -d 1 2.0e-16 and 2.7e-9).
# The frame's f32 atomics add in an order that varies from run to run; the
# SED's sums are f64 within each detect call (csrc/detect.cu), since f32
# ones, in that varying order, parted two runs by 1.7e-10 now and then
DP_CLI_BOUNDS = {"sed": 1e-12, "frame": 1e-6}


def phase_dp(torch, smi: str) -> dict:
    """Packet data parallelism (parallel/dp.py). bench1.ski (2^18 packets)
    through the CLI twice without -d and once with -d 1 (one NCCL rank),
    the three processes at once (their seconds are each one's wall from
    the common start):
    the SED and the FITS frame of -d 1 against the first plain run within
    DP_CLI_BOUNDS, and the spread between the two plain runs, which sets
    those bounds (no two runs on the card are equal byte for byte: the
    detect kernel's f32 atomics into the frame add in an order that
    varies).
    Config 1 at full width on two
    ranks sharing cuda:0 over gloo (the partials' all_reduce on host
    copies, once per segment) against one process: every SED kind within
    1e-5 and every frame within 1e-4 of its maximum (f32 sums of up to 2^20
    terms in another order); the packets/s of both."""
    import chip_smoke as cs
    from skirt9_tpu_torch.parallel import dp
    res = {"phase": "dp"}
    golden = os.path.join(GOLDEN, "bench1.ski")
    from skirt9_tpu_torch.utils import fits
    with tempfile.TemporaryDirectory() as tmp:
        runs, files, procs = {}, {}, {}
        # the three CLI runs at once: the card idles in each, and their
        # files, not their times, are held against each other
        t0 = time.perf_counter()
        for key, extra in (("plain", []), ("d1", ["-d", "1"]),
                           ("plain2", [])):
            procs[key] = subprocess.Popen(
                [sys.executable, "-m", "skirt9_tpu_torch", golden, "-o",
                 os.path.join(tmp, key), "-p", str(1 << 18), *extra],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        for key, proc in procs.items():
            _, err = proc.communicate(timeout=300)
            require(proc.returncode == 0, f"dp: the CLI {key}: {err[-800:]}")
            runs[key] = time.perf_counter() - t0
            out = os.path.join(tmp, key, "bench1_i0")
            files[key] = {"sed": np.loadtxt(out + "_sed.dat"),
                          "frame": fits.read_fits(out + "_total.fits")[0]}

        def gaps(key):
            a, b = files[key], files["plain"]
            m = np.abs(b["sed"]).max(axis=0).clip(1e-300)
            return {"sed": float((np.abs(a["sed"] - b["sed"]).max(axis=0)
                                  / m).max()),
                    "frame": float(np.abs(a["frame"] - b["frame"]).max()
                                   / np.abs(b["frame"]).max())}

        g1, spread = gaps("d1"), gaps("plain2")
        far = {k: v for k, v in g1.items() if v > DP_CLI_BOUNDS[k]}
        require(not far, f"dp: -d 1's files against the run without -d "
                f"within {DP_CLI_BOUNDS} ({g1}; two plain runs {spread})")
        res["cli"] = dict(seconds=runs, packets=1 << 18, gap_d1=g1,
                          spread_plain=spread, bounds=DP_CLI_BOUNDS)
        n = 1 << 20
        sim = config1("cuda", num_packets=n)
        one_batch(sim, sim.run_primary)            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, accs = sim.run_primary(verbose=False)
        torch.cuda.synchronize()
        one = time.perf_counter() - t0
        del sim
        torch.cuda.empty_cache()
        out = os.path.join(tmp, "two.npz")
        dp.spawn(cs._dp_rank, 2, args=(out, n), device="cuda:0",
                 backend="gloo")
        two = np.load(out)
        gaps = {}
        for key in ("sed", "frame"):
            a = accs[0][key].double().cpu().numpy()
            for k in range(a.shape[0]):
                m = np.abs(a[k]).max()
                if m > 0:
                    gaps[f"{key}{k}"] = float(np.abs(two[key][k] - a[k]).max()
                                              / m)
        # f32 sums of up to 2^20 terms a frame pixel (the central source's),
        # added in another order: ~1e-4 apart (measured 4.4e-5)
        far = {k: v for k, v in gaps.items()
               if v > (1e-4 if k.startswith("frame") else 1e-5)}
        require(not far, f"dp: two ranks against one within 1e-5 (SEDs) "
                f"and 1e-4 (frames) ({gaps})")
        res["two_ranks_shared_card"] = dict(
            packets=n, gaps=gaps, packets_per_s_one=n / one,
            packets_per_s_two=n / float(two["seconds"]), seconds_one=one,
            seconds_two=float(two["seconds"]), backend="gloo")
    emit(dict(res, device=torch.cuda.get_device_name(0), nvidia_smi=smi))
    return res


# spatial domain decomposition (phase_dd): config 1 (32^3, its RF stored)
# and config 2 (32^3, its 25-bin RF, dust emission with one secondary
# iteration) on 2 ranks, against one process on the march route; the
# reference's own bounds for its decomposed run against its replicated one
# (tests/test_domain.py:189-196, 264-269). Its per-entry RF bound, rtol
# 1e-4 on every (cell, bin) above 1% of the maximum, holds at 2^16
# packets for the 99th percentile and the median (measured on the CPU at
# the same size: 2.7e-5 and 1.1e-6) but not for every entry: the slabs sum
# a lane's depth in another order than one march, so now and then an
# interaction lands across a cell face, and after dust emission a
# secondary packet's path differs; 41 of 5,305 entries, all in the dust's
# emission bins (20-22), part by up to 3.2e-2. So every entry is held
# within 0.1, the RF's total within 1e-4.
DD_PACKETS = {"config1": 1 << 18, "config2": 1 << 16}
DD_BOUNDS = {"rf": 1e-3, "sed": 2e-3, "frame_sums": 3e-3, "sed_sum": 1e-4,
             "L_dust": 1e-4, "rf_hot_median": 1e-4, "rf_hot_p99": 1e-4,
             "rf_hot_max": 0.1, "rf_sum": 1e-4}


def dd_config(name: str, device, num_packets: int):
    """phase_dd's configuration on device: config 1 with its RF stored, or
    config 2 with one secondary iteration."""
    if name == "config1":
        return config1(device, num_packets=num_packets, store_rf=True)
    return config2(device, num_packets=num_packets, iterate_secondary=True,
                   max_iterations=1)


def dd_sim(sim, group):
    """Turn spatial domain decomposition on for a simulation built by the
    API (`Simulation.dd` with group, its engine tables rebuilt: none)."""
    sim.group, sim.dd = group, True
    sim._build_sweep_tables()
    return sim


def _dd_run(sim, name: str):
    """(rf, accs, info) of phase_dd's run of sim."""
    if name == "config2":
        return sim.run_with_dust_emission(verbose=False)
    rf, accs = sim.run_primary(verbose=False)
    return rf, accs, {}


def _dd_rank(group, out: str) -> None:
    """One rank of phase_dd's decomposed runs, each configuration of
    DD_PACKETS in turn: the first event's slab march held to its plain
    version bit for bit (_march_check, on the gathered lanes of the first
    batch), then the run with the launch counts set to 0 just before it
    and summed over the ranks just after; rank 0 saves the results."""
    import torch
    from skirt9_tpu_torch.kernels import build as kb
    from skirt9_tpu_torch.ops import rng
    from skirt9_tpu_torch.parallel import domain as dom
    from skirt9_tpu_torch.sources import base as src
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "skirt9_tpu"))
    require(not bad, f"rank {group.rank} imported {bad[:3]}")
    saved, arrays = {}, {}
    for name, n in DD_PACKETS.items():
        sim = dd_sim(dd_config(name, group.device, n), group)
        st = sim._ensure_dd()
        dec = st["dec"]
        B = -(-sim.batch_size // (group.size * 128)) * (group.size * 128)
        hist = torch.arange(B, device=sim.device)
        pkt = src.launch_batch(sim.sources[0], sim._src_tabs[0], sim.grid,
                               rng.seed_key(sim.seed, sim.device), hist, n)
        grid_loc = dom._local_grid(dec, group.rank, sim.device)
        p0, c0, _ = grid_loc.move_inside(pkt.pos, pkt.dir)
        check = _march_check(torch, "march_uniform", grid_loc, p0, pkt.dir,
                             c0, dec.max_steps_local, pkt.alive & (c0 >= 0))
        require(check["lanes_cells_differ"] == 0
                and check["max_abs_err"] == 0.0,
                f"dd: rank {group.rank}'s slab march bit for bit {check}")
        del pkt, p0, c0
        torch.cuda.synchronize()
        trips0 = group.host_trips
        # config 1's one RF bin takes the XL route on the card (dd_xl): its
        # march route here, as dd_segment's reference API runs it
        undo = _march_route(dom)
        group.barrier()
        kb.reset_launches()
        t0 = time.perf_counter()
        try:
            rf, accs, info = _dd_run(sim, name)
            torch.cuda.synchronize()
        finally:
            undo()
        dt = time.perf_counter() - t0
        counts = dict(kb.LAUNCHES)
        events = sum(x[3] for x in sim.last_stats["segments"]) \
            if "segments" in sim.last_stats else sim.last_stats["events"]
        trips = group.host_trips - trips0
        tot = torch.tensor([dt, events, trips] + list(counts.values()),
                           dtype=torch.float64)
        group.all_reduce([tot])
        if group.writes:
            arrays[f"{name}__rf"] = rf.double().cpu().numpy()
            arrays.update({f"{name}__{k}": v.double().cpu().numpy()
                           for k, v in accs[0].items()})
            saved[name] = dict(
                **{k: v for k, v in info.items() if isinstance(v, float)},
                seconds=float(tot[0]) / group.size,
                events=float(tot[1]) / group.size,
                host_trips=float(tot[2]) / group.size,
                launches=dict(zip(counts, map(int, tot[3:].tolist()))),
                march_check=check, slabs=group.size,
                slab_cells=dec.ncells_local, S_loc=dec.max_steps_local)
        del sim, rf, accs
        torch.cuda.empty_cache()
    if group.writes:
        meta = json.dumps(saved, default=lambda o: o.item()
                          if hasattr(o, "item") else str(o))
        np.savez(out, meta=np.array(meta), **arrays)


def dd_gaps(one, two, name: str) -> dict:
    """The decomposed run (two) against one process (one) within
    DD_BOUNDS: config 1's RF and SED per kind by their maxima and its frame
    sums per kind and bin; config 2's SED sum, L_dust, its RF's total and
    the relative gaps of its RF entries above 1% of the maximum (median,
    99th percentile, largest)."""
    rf1, rf2 = one["rf"], np.asarray(two["rf"])
    gaps = {}
    if name == "config1":
        gaps["rf"] = float(np.abs(rf2 - rf1).max() / np.abs(rf1).max())
        for k in range(one["sed"].shape[0]):
            m = np.abs(one["sed"][k]).max()
            if m > 0:
                gaps[f"sed{k}"] = float(np.abs(np.asarray(two["sed"][k])
                                               - one["sed"][k]).max() / m)
        fa = one["frame"].sum(axis=(2, 3))
        fb = np.asarray(two["frame"]).sum(axis=(2, 3))
        atol = 1e-6 * max(fa.max(), 1e-30)
        gaps["frame_sums"] = float((np.abs(fb - fa) / (np.abs(fa) + atol
                                                       / 3e-3)).max())
        far = {k: v for k, v in gaps.items()
               if v > DD_BOUNDS["sed" if k.startswith("sed") else k]}
    else:
        sa, sb = one["sed"].sum(), np.asarray(two["sed"]).sum()
        gaps["sed_sum"] = float(abs(sb / sa - 1))
        gaps["L_dust"] = float(abs(two["L_dust"] / one["L_dust"] - 1))
        hot = rf1 > 0.01 * rf1.max()
        rel = np.abs(rf2[hot] - rf1[hot]) / rf1[hot]
        gaps.update(rf_hot_median=float(np.median(rel)),
                    rf_hot_p99=float(np.quantile(rel, 0.99)),
                    rf_hot_max=float(rel.max()),
                    rf_sum=float(abs(rf2.sum() / rf1.sum() - 1)))
        far = {k: v for k, v in gaps.items() if v > DD_BOUNDS[k]}
        gaps["rf_hot_share_1e-4"] = float((rel <= 1e-4).mean())
    require(not far, f"dd: {name} decomposed against one process within "
            f"{DD_BOUNDS} ({gaps})")
    return gaps


def _march_route(dom):
    """Hold domain decomposition on the march route: dd_segment called with
    xl_local=None, whatever the simulation's route rule picks. Returns the
    undo."""
    orig = dom.dd_segment
    dom.dd_segment = lambda *a, **kw: orig(*a, **dict(kw, xl_local=None))

    def undo():
        dom.dd_segment = orig
    return undo


def _dd_both_rank(group, out: str, out_xl: str) -> None:
    """One rank of phase_dd's runs, then of phase_dd_xl's, in one spawn."""
    _dd_rank(group, out)
    _dd_xl_rank(group, out_xl)


def phase_dd(torch, smi: str, out_xl: str | None = None) -> dict:
    """Spatial domain decomposition (parallel/domain.py) at full width: the
    configurations of DD_PACKETS on two ranks sharing cuda:0 over gloo
    (each collective a host round trip), each slab marched by
    `march_uniform` at S_loc = 16 + 32 + 32 + 3 over the gathered lanes,
    against one process without decomposition on the march route
    (dd_gaps); the packets/s of both, the host round trips per event, and
    the slab march against its plain version (_march_check: device and
    plain ms, bound). With out_xl the same ranks then run phase_dd_xl's
    decomposed runs into out_xl (one spawn for both phases)."""
    import chip_smoke as cs
    from skirt9_tpu_torch.parallel import dp
    res = {"phase": "dd"}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dd.npz")
        t0 = time.perf_counter()
        dp.spawn(cs._dd_rank if out_xl is None else cs._dd_both_rank, 2,
                 args=(out,) if out_xl is None else (out, out_xl),
                 device="cuda:0", backend="gloo")
        res["ranks_wall_s"] = time.perf_counter() - t0
        with np.load(out) as f:
            two = json.loads(str(f["meta"]))
            for key in f.files:
                if "__" in key:
                    name, k = key.split("__")
                    two[name][k] = f[key]
    launches = {}
    for name, n in DD_PACKETS.items():
        d = two[name]
        n_two = d.pop("launches")
        sim = dd_config(name, "cuda", n)
        sim._sweep_tabs = None                       # the march route
        (rf, accs, info), n_one = drive(
            ("march_uniform",) + DETECT + DIRECTIONS, SWEEPS,
            lambda: _dd_run(sim, name))
        for k in ("march_uniform",) + DETECT + DIRECTIONS:
            require(n_two[k] > 0, f"dd: {name}: {k} launched on the "
                    f"decomposed path ({n_two[k]})")
        for k in SWEEPS + tuple(m for m in MARCH if m != "march_uniform"):
            require(n_two[k] == 0,
                    f"dd: {name}: {k} not launched ({n_two[k]})")
        one = {"rf": rf.double().cpu().numpy(),
               **{k: v.double().cpu().numpy() for k, v in accs[0].items()},
               **info}
        gaps = dd_gaps(one, d, name)
        seconds_one = sim.last_stats.get("seconds") if name == "config1" \
            else sum(x[2] for x in sim.last_stats["segments"])
        res[name] = dict(
            packets=n, gaps=gaps, bounds=DD_BOUNDS,
            packets_per_s_one=n / seconds_one, packets_per_s_two=n
            / d["seconds"], seconds_one=seconds_one,
            seconds_two=d["seconds"], events=d["events"],
            host_round_trips_per_event=d["host_trips"] / max(d["events"], 1),
            slabs=d["slabs"], slab_cells=d["slab_cells"], S_loc=d["S_loc"],
            launches_two={k: v for k, v in n_two.items() if v},
            launches_one={k: v for k, v in n_one.items() if v},
            slab_march=d["march_check"])
        launches[name] = n_two
        del sim
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    emit(dict(res, device=torch.cuda.get_device_name(0), nvidia_smi=smi,
              backend="gloo"))
    return dict(res, launches=launches)


# domain decomposition on the XL route (phase_dd_xl): config 1 on the
# full_width_xl grid (256^3) with its one-bin RF stored, at 2^16 packets, on
# two gloo ranks sharing cuda:0; the reference's bound for its XL route
# against its march route, 1e-3 of each maximum (tests/test_domain.py:
# 109-134), against one process on the XL route and against the two ranks
# on the march route
DD_XL_N = 256
DD_XL_PACKETS = 1 << 16
DD_XL_BOUND = 1e-3


def dd_xl_config(device):
    """One batch of DD_XL_PACKETS: 2^15 lanes on each of two ranks."""
    return config1(device, num_packets=DD_XL_PACKETS,
                   batch_size=DD_XL_PACKETS, n=DD_XL_N, store_rf=True)


def _spy_xl(xl):
    """Wrap sweepxl's sweep_dtau and sweep_deposit, which the XL route of
    parallel/domain.py calls: count the calls of each mode (each one
    launch of its kernel on the card) and keep the arguments of the path's
    first event: pass 1's record and the deposits, and the summed form of
    its scattering peel-off (the second summed call: the emission
    peel-off's rays start on the source, on the slabs' border). Returns
    (counts, first, undo)."""
    counts = {"want_sub": 0, "summed": 0, "sweep_deposit": 0}
    first = {}
    dtau, dep = xl.sweep_dtau, xl.sweep_deposit

    def sweep_dtau(*a, want_sub=False, **kw):
        mode = "want_sub" if want_sub else "summed"
        counts[mode] += 1
        if want_sub or counts[mode] == 2:
            first.setdefault(mode, (a, kw))
        return dtau(*a, want_sub=want_sub, **kw)

    def sweep_deposit(*a, **kw):
        counts["sweep_deposit"] += 1
        first.setdefault("sweep_deposit", (a, kw))
        return dep(*a, **kw)

    def undo():
        xl.sweep_dtau, xl.sweep_deposit = dtau, dep
    xl.sweep_dtau, xl.sweep_deposit = sweep_dtau, sweep_deposit
    return counts, first, undo


def _xl_checks(torch, first) -> dict:
    """Kernels 6 (want_sub and summed) and 7 (sweep_deposit) on the first
    event's arguments of the XL route, against their plain versions: the
    record and summed form bit for bit, the RF within 1e-4 of its maximum
    (kernels_xl's bounds); timed, with their bounds from these inputs."""
    from skirt9_tpu_torch.transport import sweep as sw
    from skirt9_tpu_torch.transport import sweepxl as xl
    out = {}
    march = lambda B, n: B * OPS_LANE + n * (OPS_SLAB + 3 * (OPS_SUB + 2) + 2)
    for mode in ("want_sub", "summed"):
        a, kw = first[mode]
        tabs, pos, dirn, sig, active = a[:5]
        want = mode == "want_sub"
        fn = lambda: xl.sweep_dtau(*a, want_sub=want, **kw)
        plain = lambda: xl.sweep_dtau_plain(*a, want_sub=want, **kw)
        k, p = fn(), plain()
        err = float((k - p).abs().max())
        require(err == 0.0, f"dd_xl: kernel 6 {mode} bit for bit ({err})")
        B = pos.shape[0]
        g, smin, smax = sw._lane_range(tabs, pos, dirn, active)
        n_act = active_slabs(tabs, pos, dirn, g, smin, smax)
        rec = tabs.nmax * B * 4
        del k, p
        out[mode] = dict(
            max_abs_err=err, lanes=B, active_pairs=n_act, ms=cuda_ms(fn),
            device_ms=device_ms(fn)["ours"],
            plain_ms=cuda_ms(plain, reps=3), library_ms=None,
            **bound(ray_bytes(B, sig.shape[0]) + tabs.nd.numel() * 4
                    + (3 if want else 1) * rec, march(B, n_act)))
    a, kw = first["sweep_deposit"]
    tabs, pos, dirn, active = a[:4]
    fn = lambda: xl.sweep_deposit(*a, **kw)
    plain = lambda: xl.sweep_deposit_plain(*a, **kw)
    k, p = fn(), plain()
    err = float((k - p).abs().max())
    m = float(p.abs().max())
    require(m > 0 and err <= 1e-4 * m,
            f"dd_xl: kernel 7 RF error {err} <= 1e-4 * {m}")
    B = pos.shape[0]
    g, smin, smax = sw._lane_range(tabs, pos, dirn, active)
    n_act = active_slabs(tabs, pos, dirn, g, smin, smax)
    out["sweep_deposit"] = dict(
        max_abs_err=err, err_of_max=err / m, lanes=B, active_pairs=n_act,
        ms=cuda_ms(fn), device_ms=device_ms(fn)["ours"],
        plain_ms=cuda_ms(plain, reps=3), library_ms=None,
        **bound(lane_bytes(B, 0) + 4 * tabs.nmax * B * 4
                + tabs.nd.shape[0] * 4,
                n_act * (OPS_SLAB + 3 * (OPS_SUB + OPS_DEP))))
    return out


def _dd_xl_rank(group, out: str) -> None:
    """One rank of phase_dd_xl: config 1 at 256^3 decomposed, on the XL
    route (the route rule's on the card, its kernels spied by _spy_xl and,
    on rank 0, held against their plain versions after the run) and on the
    march route (dd_segment(xl_local=None)); each run with the launch
    counts set to 0 just before it and summed over the ranks just after;
    rank 0 saves the results."""
    import torch
    from skirt9_tpu_torch.kernels import build as kb
    from skirt9_tpu_torch.parallel import domain as dom
    from skirt9_tpu_torch.transport import sweepxl as xl
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "skirt9_tpu"))
    require(not bad, f"rank {group.rank} imported {bad[:3]}")
    saved, arrays = {}, {}
    sim = dd_sim(dd_xl_config(group.device), group)
    for route in ("xl", "march"):
        sim._dd_cache.clear()          # each route builds its own runner
        if route == "xl":
            counts, first, undo = _spy_xl(xl)
        else:
            counts, first, undo = {}, {}, _march_route(dom)
        trips0 = group.host_trips
        group.barrier()
        kb.reset_launches()
        t0 = time.perf_counter()
        try:
            rf, accs = sim.run_primary(verbose=False)
            torch.cuda.synchronize()
        finally:
            undo()
        dt = time.perf_counter() - t0
        launches = dict(kb.LAUNCHES)
        require(("xl_local" in sim._dd_state) and launches[
            "march_uniform"] == 0 if route == "xl" else launches[
            "sweepxl_dtau"] == 0, f"dd_xl: the {route} route taken")
        trips = group.host_trips - trips0
        tot = torch.tensor([dt, sim.last_stats["events"], trips]
                           + list(launches.values()) + list(counts.values()),
                           dtype=torch.float64)
        group.all_reduce([tot])
        checks = (_xl_checks(torch, first) if route == "xl" and group.writes
                  else None)
        first.clear()
        group.barrier()
        if group.writes:
            arrays[f"{route}__rf"] = rf.double().cpu().numpy()
            arrays.update({f"{route}__{k}": v.double().cpu().numpy()
                           for k, v in accs[0].items()})
            nk = len(launches)
            saved[route] = dict(
                seconds=float(tot[0]) / group.size,
                events=float(tot[1]) / group.size,
                host_trips=float(tot[2]) / group.size,
                launches=dict(zip(launches, map(int, tot[3:3 + nk]))),
                modes=dict(zip(counts, map(int, tot[3 + nk:].tolist()))),
                checks=checks, slab_cells=sim._dd_state["dec"].ncells_local)
        del rf, accs
        torch.cuda.empty_cache()
    if group.writes:
        meta = json.dumps(saved, default=lambda o: o.item()
                          if hasattr(o, "item") else str(o))
        np.savez(out, meta=np.array(meta), **arrays)


def route_gaps(a: dict, b: dict, what: str) -> dict:
    """b against a within DD_XL_BOUND of each maximum: the RF, the SED of
    each kind and the frame's sums per kind and bin."""
    g = lambda x, y: float(np.abs(np.asarray(y) - x).max()
                           / max(np.abs(x).max(), 1e-300))
    gaps = {"rf": g(a["rf"], b["rf"])}
    for k in range(a["sed"].shape[0]):
        if np.abs(a["sed"][k]).max() > 0:
            gaps[f"sed{k}"] = g(a["sed"][k], b["sed"][k])
    gaps["frame_sums"] = g(a["frame"].sum(axis=(2, 3)),
                           np.asarray(b["frame"]).sum(axis=(2, 3)))
    require(max(gaps.values()) <= DD_XL_BOUND,
            f"dd_xl: {what} within {DD_XL_BOUND} of each maximum ({gaps})")
    return gaps


def phase_dd_xl(torch, smi: str, ranks_out: str | None = None) -> dict:
    """Domain decomposition on the XL route at full width (DD_XL_N^3, one
    RF bin): two ranks sharing cuda:0 over gloo on the XL route (kernels 6
    and 7 in the modes the reference composes, held against their plain
    versions on the path's first event) and on the march route, against one
    process on the XL route (route_gaps); packets/s of the three runs and
    the host round trips per event. ranks_out: the two ranks' results
    where phase_dd's ranks ran them, else they are spawned here."""
    import chip_smoke as cs
    from skirt9_tpu_torch.parallel import dp
    res = {"phase": "dd_xl", "grid": [DD_XL_N] * 3, "packets": DD_XL_PACKETS}
    with tempfile.TemporaryDirectory() as tmp:
        out = ranks_out or os.path.join(tmp, "dd_xl.npz")
        t0 = time.perf_counter()
        if ranks_out is None:
            dp.spawn(cs._dd_xl_rank, 2, args=(out,), device="cuda:0",
                     backend="gloo")
            res["ranks_wall_s"] = time.perf_counter() - t0
        with np.load(out) as f:
            two = json.loads(str(f["meta"]))
            for key in f.files:
                if "__" in key:
                    route, k = key.split("__")
                    two[route][k] = f[key]
    sim = dd_xl_config("cuda")
    (rf, accs), n_one = drive(XL + DETECT, RESIDENT + ML + NOT_PATH,
                              lambda: sim.run_primary(verbose=False))
    one = {"rf": rf.double().cpu().numpy(),
           **{k: v.double().cpu().numpy() for k, v in accs[0].items()}}
    seconds_one = sim.last_stats["seconds"]
    del sim, rf, accs
    torch.cuda.empty_cache()
    xl_two, march_two = two["xl"], two["march"]
    n_xl, n_march = xl_two["launches"], march_two["launches"]
    modes = xl_two["modes"]
    for k in ("want_sub", "summed", "sweep_deposit"):
        require(modes[k] > 0, f"dd_xl: kernel mode {k} launched ({modes})")
    require(n_xl["sweepxl_dtau"] == modes["want_sub"] + modes["summed"]
            and n_xl["sweepxl_deposit"] == modes["sweep_deposit"],
            f"dd_xl: one launch per call ({n_xl}, {modes})")
    for k in DETECT + DIRECTIONS:
        require(n_xl[k] > 0 and n_march[k] > 0, f"dd_xl: {k} launched")
    for k in RESIDENT + ML + XL + ("sweep_dtau", "sweep_deposit",
                                   "mlsweep_dtau", "scatter_add") + MARCH:
        require(n_xl[k] == 0, f"dd_xl: {k} not launched on the XL route")
    require(n_march["march_uniform"] > 0 and all(
        n_march[k] == 0 for k in XL + ("sweepxl_dtau", "sweepxl_deposit")),
        "dd_xl: the march route marches")
    for route, d in (("xl_two_ranks", xl_two), ("march_two_ranks",
                                                march_two)):
        res[route] = dict(
            packets_per_s=DD_XL_PACKETS / d["seconds"], seconds=d["seconds"],
            events=d["events"],
            host_round_trips_per_event=d["host_trips"] / max(d["events"], 1),
            launches={k: v for k, v in d["launches"].items() if v},
            gaps_to_xl_one_process=route_gaps(one, d, route))
    res["xl_two_ranks"]["modes"] = modes
    res["xl_two_ranks"]["kernels"] = xl_two["checks"]
    res["xl_two_ranks"]["gaps_to_march_two_ranks"] = route_gaps(
        march_two, xl_two, "the XL route against the march route")
    res["xl_one_process"] = dict(
        packets_per_s=DD_XL_PACKETS / seconds_one, seconds=seconds_one,
        launches={k: v for k, v in n_one.items() if v})
    res["slab_cells"] = xl_two["slab_cells"]
    res["seconds"] = time.perf_counter() - t0
    emit(dict(res, device=torch.cuda.get_device_name(0), nvidia_smi=smi,
              backend="gloo", bound=DD_XL_BOUND))
    return dict(res, launches=n_xl)


# the local instruments (phase_local_instruments): three observers inside
# config 1's dust sphere (radius 1 pc), their wavelength grid the distant
# instrument's; the perspective camera looks at the source at the origin
LOCAL_PACKETS = 1 << 17
LOCAL_SECONDARY_PACKETS = 1 << 16
# config 1's source of 1 W puts ~1e-39 W/m^2 into a local map, below f32's
# normal range, which the reference (and the port after it) flushes to
# zero: the local runs give it a solar luminosity
LOCAL_LUMINOSITY = 3.828e26
LOCAL_FLUX_BOUND = 1e-3          # tests/test_allsky.py:42, rel 1e-3
# the card's maps against the CPU's: 1e-4 of each map's maximum, but the
# camera's scattered light, 1e-3: its brightest pixels hold scatterings a
# hair from the eye, whose 1/z'^2 turns the card's path depths, within
# 1e-6 of the CPU's (kernel 1's total and prefix), into 1.1e-4 of the map's
# maximum (measured on an H100, PR 24)
LOCAL_CPU_BOUND = 1e-4
LOCAL_CPU_BOUND_CAMERA_SCATTERED = 1e-3
# the card against the CPU on LOCAL_CPU_PACKETS of the same histories in
# batches of LOCAL_CPU_BATCH: index_add_ sums a batch's equal direct
# contributions one after another in f32, which strays ~N 2^-25 from their
# sum (4.6e-5 at 4,096 of them, 1.2e-3 at 2^17, measured on the CPU)
LOCAL_CPU_PACKETS = 1 << 14
LOCAL_CPU_BATCH = 1 << 12


def local_instruments(wave_borders) -> list:
    """The Mollweide all-sky map, the HEALPix map (a crosshair: the source)
    and the perspective camera (its crosshair the source, 0.7 pc away)."""
    from skirt9_tpu_torch.instruments.allsky import AllSkyInstrumentCfg
    from skirt9_tpu_torch.instruments.perspective import (
        PerspectiveInstrumentCfg)
    wb = tuple(wave_borders)
    return [AllSkyInstrumentCfg(name="allsky", wave_borders=wb,
                                position=(0.5 * PC, 0.0, 0.0), npx=250),
            AllSkyInstrumentCfg(name="healpix", wave_borders=wb,
                                position=(0.0, -0.4 * PC, 0.2 * PC),
                                projection="healpix", order=5,
                                crosshair=(0.0, 0.0, 0.0)),
            PerspectiveInstrumentCfg(name="camera", wave_borders=wb,
                                     npx=250, npy=250, width=1.0 * PC,
                                     view=(0.0, 0.0, 0.5 * PC),
                                     cross=(0.0, 0.0, 0.0),
                                     up=(0.0, 1.0, 0.0), focal=0.2 * PC)]


def local_config(device, name: str = "config1", **kw):
    """Config 1 (or config 2 with dust emission and one secondary
    iteration) with its distant instrument and the three local ones."""
    import dataclasses
    if name == "config1":
        sim = config1(device, num_packets=kw.pop("num_packets",
                                                 LOCAL_PACKETS), **kw)
        sources = [dataclasses.replace(sim.sources[0],
                                       luminosity=LOCAL_LUMINOSITY)]
    else:
        sim = config2(device, num_packets=LOCAL_SECONDARY_PACKETS,
                      iterate_secondary=True, max_iterations=1, **kw)
        sources = sim.sources
    # the statistics' scale follows the new luminosity
    distant = [dataclasses.replace(c, stats_scale=1.0)
               for c in sim.instruments]
    return dataclasses.replace(sim, sources=sources, instruments=distant
                               + local_instruments(
                                   sim.instruments[0].wave_borders))


def _spy_scatter(sca, keep: int):
    """Wrap ops.scatteradd.scatter_add, which the local instruments' detect
    calls: keep the arguments of call number keep (the first scattering
    peel-off's first map after the emission's three). Returns (kept,
    undo)."""
    kept, calls = [], [0]
    orig = sca.scatter_add

    def scatter_add(idx, val, size):
        if calls[0] == keep:
            kept.append((idx.clone(), val.clone(), size))
        calls[0] += 1
        return orig(idx, val, size)

    def undo():
        sca.scatter_add = orig
    sca.scatter_add = scatter_add
    return kept, undo


def _scatter_check(torch, idx, val, size: int) -> dict:
    """Kernel 3 on the path's arguments against scatter_add_plain (f32
    index_add_) and against the f64 sum, within the f32 atomics' own error
    per bin (n 2^-24 sum |v|, n the bin's terms), and on the path's indices
    with integer values 0-15 (every sum exact in f32 in any order) bit for
    bit against the f64 sums, which a dropped lane, warp or block fails;
    its device ms first (the profiler, retaken where it lost the kernel's
    events: ROADMAP B item 50), timed beside the index_add_ call, bound by
    its bytes (the indices and values read once, the bins written once)."""
    from skirt9_tpu_torch.ops import scatteradd as sca
    fn = lambda: sca.scatter_add(idx, val, size)
    lib = lambda: torch.zeros(size, dtype=torch.float32,
                              device=val.device).index_add_(0, idx.long(), val)
    torch.cuda.synchronize()
    for tries in range(1, 4):
        dev_ms, lib_dev = device_ms(fn), device_ms(lib)
        if dev_ms["ours"] > 0 and lib_dev["all"] > 0:
            break
    ints = torch.tensor(np.random.default_rng(3).integers(
        0, 16, idx.shape[0]).astype(np.float32), device=val.device)
    exact = torch.zeros(size, dtype=torch.float64, device=val.device
                        ).index_add_(0, idx.long(), ints.double())
    require(torch.equal(sca.scatter_add(idx, ints, size).double(), exact),
            "local_instruments: kernel 3 on the path's indices with integer "
            "values bit for bit against the f64 sums")
    k = sca.scatter_add(idx, val, size)
    p = sca.scatter_add_plain(idx, val, size)
    ex = torch.zeros(size, dtype=torch.float64, device=val.device).index_add_(
        0, idx.long(), val.double())
    n = torch.zeros(size, dtype=torch.float64, device=val.device).index_add_(
        0, idx.long(), torch.ones_like(val, dtype=torch.float64))
    a = torch.zeros(size, dtype=torch.float64, device=val.device).index_add_(
        0, idx.long(), val.double().abs())
    err = (k.double() - ex).abs()
    require(bool((err <= n * 2.0 ** -24 * a).all()),
            "local_instruments: kernel 3 within the f32 atomics' error of "
            "the f64 sum")
    B = idx.shape[0]
    return dict(max_abs_err=float((k - p).abs().max()),
                max_abs_err_f64=float(err.max()), lanes=B, bins=size,
                lit_bins=int((n > 0).sum()), exact_ints=True, ms=cuda_ms(fn),
                device_ms=dev_ms["ours"], device_ms_all=dev_ms["all"],
                device_launches=dev_ms["launches"], profiler_tries=tries,
                profiler_dropped=dev_ms["ours"] == 0,
                plain_ms=cuda_ms(lambda: sca.scatter_add_plain(idx, val,
                                                               size)),
                library_ms=cuda_ms(lib), library_device_ms=lib_dev["all"],
                **bound(B * 8 + size * 4, B))


def local_flux_gates(torch, sim_cpu, accs) -> dict:
    """The point source's direct flux in each local map against L e^-tau /
    (4 pi d^2): d the distance from the source to the observer (the eye for
    the camera), tau by the plain march from the source toward it through
    the whole grid, past the observer, as the reference's local peel-off
    traces it; the camera's brightest direct pixel the crosshair's. The
    direct light has no Monte Carlo spread (every packet carries L/N along
    the same ray), so the gate is the reference test's rel 1e-3."""
    from skirt9_tpu_torch.instruments import distant as dinst
    from skirt9_tpu_torch.media import system as msys
    from skirt9_tpu_torch.transport import march as mr
    src = np.asarray(sim_cpu.sources[0].position, np.float64)
    L = float(sim_cpu.sources[0].luminosity)
    out = {}
    for cfg, tab, acc in zip(sim_cpu.instruments[1:], sim_cpu._inst_tabs[1:],
                             accs[1:]):
        obs = tab["obs"].double().numpy()
        d = float(np.linalg.norm(obs - src))
        k = torch.tensor(((obs - src) / d)[None], dtype=torch.float32)
        p0 = torch.tensor(src[None], dtype=torch.float32)
        c0 = sim_cpu.grid.locate(p0)
        opt = msys.optics_at(sim_cpu.medium, torch.full((1,), 0.55e-6))
        tau = float(mr.trace_tau(sim_cpu.grid, sim_cpu.medium, opt, p0, k,
                                 c0, sim_cpu.options.max_steps, c0 >= 0))
        expect = L * math.exp(-tau) / (4 * math.pi * d * d)
        sky = acc["sky"][dinst.KIND_PRIMARY_DIRECT].double()
        got = float(sky.sum())
        gap = abs(got / expect - 1)
        require(gap <= LOCAL_FLUX_BOUND, f"local_instruments: {cfg.name}'s "
                f"direct flux {got} against {expect} (tau {tau})")
        out[cfg.name] = dict(direct=got, expected=expect, tau=tau,
                             distance_pc=d / PC, rel_gap=gap)
        if getattr(cfg, "is_perspective", False):
            j, i = np.unravel_index(int(torch.argmax(sky[0])), sky[0].shape)
            require((i, j) == (cfg.npx // 2, cfg.npy // 2),
                    f"local_instruments: the source on the crosshair's "
                    f"pixel ({i}, {j})")
            out[cfg.name]["pixel"] = [int(i), int(j)]
    return out


def phase_local_instruments(torch, smi: str) -> dict:
    """Config 1 at full width with the three local instruments on the card
    (drive: the resident sweep, detect for the distant instrument, kernel
    3 for the local maps), its maps against the direct flux of the source
    (local_flux_gates), and LOCAL_CPU_PACKETS of its histories on the card
    against the CPU's; kernel 3 at the first scattering peel-off (_scatter_check); config 2
    with dust emission: the secondary kinds of the maps."""
    from skirt9_tpu_torch.ops import scatteradd as sca
    t0 = time.perf_counter()
    sim = local_config("cuda")
    kept, undo = _spy_scatter(sca, 3)
    try:
        (_, accs), launches = drive(
            RESIDENT + DETECT + DIRECTIONS + ("scatter_add",),
            XL + ML + NOT_PATH[:-1], lambda: sim.run_primary(verbose=False))
    finally:
        undo()
    seconds = sim.last_stats["seconds"]
    events = sim.last_stats["events"]
    flux = local_flux_gates(torch, local_config("cpu"), [
        {k: v.cpu() for k, v in a.items()} for a in accs])
    # the card against the CPU on the same histories, in short batches
    small = lambda dev: local_config(dev, num_packets=LOCAL_CPU_PACKETS,
                                     batch_size=LOCAL_CPU_BATCH)
    _, accs_gpu = small("cuda").run_primary(verbose=False)
    t1 = time.perf_counter()
    _, accs_cpu = small("cpu").run_primary(verbose=False)
    cpu_s = time.perf_counter() - t1
    gaps = {}
    for cfg, a, b in zip(sim.instruments[1:], accs_gpu[1:], accs_cpu[1:]):
        for kind in range(a["sky"].shape[0]):
            x, y = a["sky"][kind].double().cpu(), b["sky"][kind].double()
            m = float(y.abs().max())
            if m > 0:
                gaps[f"{cfg.name}{kind}"] = float((x - y).abs().max()) / m
    scattered = ("camera2", "camera4")
    far = {k: g for k, g in gaps.items() if g > (
        LOCAL_CPU_BOUND_CAMERA_SCATTERED if k in scattered
        else LOCAL_CPU_BOUND)}
    require(len(gaps) == 6 and not far,
            f"local_instruments: the card's maps against the CPU's within "
            f"{LOCAL_CPU_BOUND} of each maximum ({gaps})")
    check = _scatter_check(torch, *kept[0])
    with tempfile.TemporaryDirectory() as tmp:
        paths = sim.write_outputs(accs, "local", tmp)
        files = sorted(os.path.basename(p) for p in paths
                       if "allsky" in p or "camera" in p)
    del sim, accs, accs_gpu, accs_cpu, kept
    torch.cuda.empty_cache()
    # the secondary kinds: config 2 with dust emission
    sim2 = local_config("cuda", "config2")
    (_, accs2, info), launches2 = drive(
        RESIDENT + DETECT + ("scatter_add",), XL + ML + NOT_PATH[:-1],
        lambda: sim2.run_with_dust_emission(verbose=False))
    secondary = {}
    for cfg, a in zip(sim2.instruments[1:], accs2[1:]):
        sky = a["sky"].double()
        secondary[cfg.name] = [float(sky[k].sum()) for k in (3, 4)]
        require(bool(torch.isfinite(sky).all()) and min(
            secondary[cfg.name]) > 0, f"local_instruments: {cfg.name}'s "
            f"secondary kinds ({secondary[cfg.name]})")
    del sim2, accs2
    torch.cuda.empty_cache()
    res = {"phase": "local_instruments", "packets": LOCAL_PACKETS,
           "packets_per_s": LOCAL_PACKETS / seconds, "seconds": seconds,
           "events": events, "cpu_packets": LOCAL_CPU_PACKETS,
           "cpu_batch": LOCAL_CPU_BATCH, "cpu_seconds": cpu_s,
           "cpu_gaps": gaps,
           "flux": flux, "files": files,
           "scatter_add_per_event": launches["scatter_add"] / max(events, 1),
           "launches": {k: v for k, v in launches.items() if v},
           "scatter_add": check, "secondary_packets": LOCAL_SECONDARY_PACKETS,
           "secondary_kinds": secondary,
           "launches_config2": {k: v for k, v in launches2.items() if v},
           "phase_s": time.perf_counter() - t0}
    emit(dict(res, device=torch.cuda.get_device_name(0), nvidia_smi=smi))
    return dict(res, launches=launches, launches2=launches2)


def main() -> int:
    import torch
    from skirt9_tpu_torch import device  # fails outside the repository
    try:
        device.require_cuda()
    except RuntimeError as err:
        print(f"chip_smoke: {err}", file=sys.stderr)
        return 2
    # the plain versions' CPU runs beside the card: four torch threads ran
    # config 1's CPU run 3.7x faster than eight on the card's 8-core host
    # (perf/cpu_threads.py: 3.77 s against 13.80 s)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    smi = phase_env(torch)
    phase_build()
    # the march kernel's device times first, while the profiler is fresh
    kern_march = phase_kernels_march(torch)
    kern_march.update(phase_kernels_march_tree(torch))
    kern_march.update(phase_kernels_march_curvi(torch))
    kern_march.update(phase_kernels_march_amr(torch))
    kern_march.update(phase_kernels_march_polar(torch))
    kern_march.update(phase_kernels_march_clumpy(torch))
    kern_sincos = phase_kernels_sincos(torch)
    kern_mesh = phase_kernels_march_tetra(torch)
    kern_march["march_tetra"] = kern_mesh["march_tetra"]
    kern_b5_tree = phase_kernels_b5_tree(torch)
    kern_amr = phase_kernels_amr(torch)
    kern = phase_kernels(torch)
    kern.update(phase_kernels_xl(torch))
    torch.cuda.empty_cache()
    kern.update(phase_kernels_probe(torch))
    kern_b2 = phase_kernels_b2(torch)
    torch.cuda.empty_cache()
    phase_draw_for_draw(torch)
    phase_draw_for_draw(torch, "draw_for_draw_xl", n=80, tables="XLTables")
    sim, stats, launches = phase_full_width(torch, smi)
    sweep_b1 = {"scattered": stats["gates"]["scattered"],
                "packets_per_s": sim.last_rate}
    phase_breakdown(torch, sim, stats)
    del sim
    _, _, launches_xl = phase_full_width(
        torch, smi, "full_width_xl", "XLTables", XL + DETECT,
        RESIDENT + ML + NOT_PATH, num_packets=B_FULL, n=256)
    launches_rf = phase_rf_xl(torch)
    torch.cuda.empty_cache()
    kern.update(phase_kernels_ml(torch))
    torch.cuda.empty_cache()
    phase_draw_for_draw_ml(torch)
    sim, launches_ml = phase_full_width_ml(torch, smi)
    rate_ml = sim.last_rate
    phase_breakdown_ml(torch, sim)
    del sim
    phase_full_width_ml(torch, smi, "full_width_ml_large", "config3ismxl")
    sim, launches_rf_ml = phase_full_width_ml(torch, smi, "rf_ml",
                                              store_rf=True)
    emit({"phase": "rf_ml_vs_full_width_ml", "packets_per_s_rf":
          sim.last_rate, "packets_per_s": rate_ml,
          "ratio": sim.last_rate / rate_ml})
    del sim
    torch.cuda.empty_cache()
    phase_draw_for_draw_b2(torch)
    sim, launches_b2 = phase_full_width_b2(torch, smi)
    phase_breakdown_b2(torch, sim)
    del sim
    torch.cuda.empty_cache()
    kern_b3 = phase_kernels_b3(torch)
    torch.cuda.empty_cache()
    phase_draw_for_draw_b3(torch)
    sim, launches_b3, res_b3 = phase_full_width_b3(torch, smi)
    sweep_b3 = {k: res_b3[k] for k in res_b3 if k.endswith("ratio")
                or k in ("packets_per_s", "seconds", "iterations")}
    phase_breakdown_b3(torch, sim)
    del sim
    torch.cuda.empty_cache()
    launches_1h = phase_refill_b1h(torch, smi)
    torch.cuda.empty_cache()
    phase_cli(torch, smi)
    torch.cuda.empty_cache()
    kern.update(sweepxl_deposit_prefix_grouped=phase_kernels_xl_grouped(torch))
    torch.cuda.empty_cache()
    kern.update(phase_kernels_treexl(torch))
    torch.cuda.empty_cache()
    phase_draw_for_draw_xl_b2(torch)
    sim, launches_b2x256 = phase_full_width_b2x256(torch, smi)
    torch.cuda.empty_cache()
    phase_rf_xl_b2x256(torch, sim)
    del sim
    torch.cuda.empty_cache()
    _, launches_treexl = phase_full_width_ml(torch, smi, "full_width_treexl",
                                             "config3ismxl9")
    torch.cuda.empty_cache()
    _, launches_rf_treexl = phase_full_width_ml(torch, smi, "rf_treexl",
                                                "config3ismxl9", store_rf=True)
    torch.cuda.empty_cache()
    phase_treexl_vs_ml(torch)
    torch.cuda.empty_cache()
    kern_b5 = phase_kernels_b5(torch)
    torch.cuda.empty_cache()
    phase_draw_for_draw_b5(torch)
    sim, launches_b5, uniform_b5 = phase_full_width_b5(torch, smi)
    phase_breakdown_b5(torch, sim)
    del sim
    torch.cuda.empty_cache()
    kern_b6 = phase_kernels_b6(torch)
    torch.cuda.empty_cache()
    phase_draw_for_draw_b67(torch, "bench6")
    phase_draw_for_draw_b67(torch, "bench7")
    launches_b6 = phase_full_width_b67(torch, smi, "bench6")
    launches_b7 = phase_full_width_b67(torch, smi, "bench7")
    phase_breakdown_b6(torch)
    torch.cuda.empty_cache()
    kern_b4 = phase_kernels_b4(torch)
    torch.cuda.empty_cache()
    phase_draw_for_draw_b4(torch)
    launches_b4, raster_b4 = phase_full_width_b4(torch, smi)
    phase_breakdown_b4(torch)
    torch.cuda.empty_cache()
    # the scan march
    launches_small = phase_draw_for_draw_march(torch)
    torch.cuda.empty_cache()
    launches_walk = phase_full_width_b4_walk(torch, smi, raster_b4)
    torch.cuda.empty_cache()
    launches_b1_march = phase_full_width_b1_march(torch, smi, sweep_b1)
    torch.cuda.empty_cache()
    # trees on the march, and the options on the tree and XL sweeps
    launches_b3_march = phase_full_width_b3_march(torch, smi, sweep_b3)
    torch.cuda.empty_cache()
    launches_b5_tree = phase_full_width_b5_tree(torch, smi, uniform_b5)
    torch.cuda.empty_cache()
    # geometric sources, the 1D sphere and the 2D cylinder
    launches_geo_small = phase_draw_for_draw_march(
        torch, "draw_for_draw_geometric", list(GEO_CASES))
    torch.cuda.empty_cache()
    launches_disk_cyl, ivezic_launches = phase_full_width_geometric(
        torch, smi, "disk_cyl")
    launches_disk_tree, _ = phase_full_width_geometric(torch, smi,
                                                        "disk_tree")
    torch.cuda.empty_cache()
    # imported hydro snapshots: AMR meshes and SPH particles
    imports_small = phase_draw_for_draw_imports(torch)
    launches_amr = phase_full_width_amr(torch, smi, "amr_galaxy")
    launches_amr_march = phase_full_width_amr(torch, smi, "amr_galaxy_march")
    launches_sph = phase_full_width_sph(torch, smi)
    torch.cuda.empty_cache()
    # the polar grids and the unstructured meshes
    launches_mesh_small = phase_draw_for_draw_meshes(torch)
    launches_mesh, point_launches = {}, {}
    for name in ("torus_sphere2d", "spiral_sphere3d", "spiral_cylinder3d",
                 "tetra_galaxy", "tetra_galaxy_march", "voronoi_density",
                 "clumpy_torus"):
        launches_mesh[name], point_launches[name] = phase_full_width_mesh(
            torch, smi, name)
        torch.cuda.empty_cache()
    _MESH_SIMS.clear()
    torch.cuda.empty_cache()
    launches_ivezic_dust = phase_full_width_ivezic_dust(torch, smi)
    phase_dp(torch, smi)
    # one spawn of two ranks for the dd and dd_xl phases
    xl_dir = tempfile.mkdtemp()
    xl_out = os.path.join(xl_dir, "dd_xl.npz")
    dd = phase_dd(torch, smi, xl_out)
    dd_xl = phase_dd_xl(torch, smi, xl_out)
    shutil.rmtree(xl_dir)
    local = phase_local_instruments(torch, smi)
    rows = []
    k1 = "skirt9_tpu/transport/sweep.py:238"
    k6 = "skirt9_tpu/transport/sweepxl.py:392"
    k7 = "skirt9_tpu/transport/sweepxl.py:493"
    k4 = "skirt9_tpu/transport/mlsweep.py:635"
    k1_modes = ("sweep_dtau", "sweep_tau_total", "sweep_dtau_prefix")
    probe_k3 = {"scatter_add": kern["probe_scatter_smem"]["kernel3_launches"]}
    for name, src, ref, path, counts in (
            ("sweep_dtau", "sweep_dtau.cu", k1, "full_width", launches),
            ("sweep_tau_total", "sweep_dtau.cu", k1, "full_width", launches),
            ("sweep_dtau_prefix", "sweep_dtau.cu", k1, "full_width",
             launches),
            ("sweep_deposit", "sweep_deposit.cu",
             "skirt9_tpu/transport/sweep.py:275", "full_width", launches),
            ("sweep_deposit_prefix", "sweep_deposit.cu",
             "skirt9_tpu/transport/sweep.py:275", "full_width", launches),
            ("detect", "detect.cu", "skirt9_tpu/ops/scatteradd.py:32 (its "
             "seven calls per skirt9_tpu/instruments/distant.py:157 detect)",
             "full_width", launches),
            ("scatter_add", "scatter_add.cu", "skirt9_tpu/ops/scatteradd.py:32",
             "kernels_probe (the gather probe's entry point)", probe_k3),
            ("sweepxl_dtau", "sweepxl_dtau.cu", k6, "full_width_xl",
             launches_xl),
            ("sweepxl_dtau_summed", "sweepxl_dtau.cu", k6, "full_width_xl",
             launches_xl),
            ("sweepxl_tau_total", "sweepxl_dtau.cu", k6, "full_width_xl",
             launches_xl),
            ("sweepxl_dtau_prefix", "sweepxl_dtau.cu", k6, "full_width_xl",
             launches_xl),
            ("sweepxl_deposit", "sweepxl_deposit.cu", k7, "rf_xl",
             launches_rf),
            ("sweepxl_deposit_prefix", "sweepxl_deposit.cu", k7, "rf_xl",
             launches_rf),
            ("mlsweep_dtau", "mlsweep_dtau.cu", k4, "full_width_ml",
             launches_ml),
            ("mlsweep_tau_total", "mlsweep_dtau.cu", k4, "full_width_ml",
             launches_ml),
            ("mlsweep_dtau_prefix", "mlsweep_dtau.cu", k4, "full_width_ml",
             launches_ml),
            ("mlsweep_deposit", "mlsweep_deposit.cu",
             "skirt9_tpu/transport/mlsweep.py:719", "rf_ml",
             launches_rf_ml)):
        k = kern[name]
        # kernel 6's summed form counts under its record form's name
        counter = "sweepxl_dtau" if name == "sweepxl_dtau_summed" else name
        row = {"name": name, "route": "cuda",
               "source": f"skirt9_tpu_torch/csrc/{src}", "replaces": ref,
               "path": path, "launches": counts[counter],
               **{key: k[key] for key in (
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")}}
        for key in ("device_ms", "library_device_ms", "unfused_ms",
                    "unfused_device_ms", "seven_call_ms",
                    "seven_call_device_ms", "seven_call_device_launches",
                    "bound_full_record_ms", "device_ms_no_rf",
                    "max_err_of_tau", "ms_unsorted", "prefix_ms_unsorted",
                    "kernel1_ms_sorted", "kernel1_ms_unsorted", "variants",
                    "device_ms_all", "ms_no_rf", "bound_no_rf_ms",
                    "unfused_no_rf_ms", "resolve_interaction_device_ms",
                    "resolve_interaction_launches", "ms_no_leaf_ids",
                    "device_ms_no_leaf_ids", "bound_no_leaf_ids_ms",
                    "resolve_interaction_lane_device_ms"):
            if key in k:
                row[key] = k[key]
        if name == "sweep_dtau":
            # one CUDA kernel in three output modes: its launches on the
            # path are those of the two modes the path takes
            row["launches"] = sum(counts[m] for m in k1_modes)
            row["launches_by_mode"] = {m: counts[m] for m in k1_modes}
        if name.startswith("sweepxl_deposit"):
            # launched on the XL path without an RF too
            row["launches_full_width_xl"] = launches_xl[name]
        if "large_tree" in k:
            row["large_tree"] = {key: v for key, v in k["large_tree"].items()
                                 if key in (
                "max_abs_err", "max_err_of_tau", "ms", "device_ms",
                "plain_ms", "unfused_device_ms", "bound_ms", "bound_by",
                "leaves", "shared_table", "resolve_interaction_device_ms",
                "resolve_interaction_lane_device_ms", "variants")}
        if name in k1_modes + RESIDENT + DETECT + ("sweep_deposit",
                                                   "scatter_add"):
            # the config-2 path (full_width_b2) and, for kernels 2, 3 and
            # detect, their config-2 shapes (kernels_b2)
            row["launches_config2"] = (sum(launches_b2[m] for m in k1_modes)
                                       if name == "sweep_dtau"
                                       else launches_b2[name])
            if name in kern_b2:
                row["config2"] = {key: kern_b2[name][key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "device_ms", "seven_call_ms",
                    "seven_call_device_ms") if key in kern_b2[name]}
        if name in ("mlsweep_dtau",) + ML + DETECT:
            # the config-3 path (full_width_b3) and, for kernel 5, its
            # grouped mode at config 3's shapes (kernels_b3)
            row["launches_config3"] = launches_b3[name]
            if name == "mlsweep_deposit":
                row["config3"] = {key: kern_b3[key] for key in (
                    "max_abs_err", "err_of_max", "ms", "device_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "n_groups", "rows", "leaves", "shared_table",
                    "live_share")}
        if name in k1_modes + RESIDENT + DETECT:
            # the config-5 path (full_width_b5) and detect's Stokes mode at
            # config 5's shapes (kernels_b5)
            row["launches_config5"] = (sum(launches_b5[m] for m in k1_modes)
                                       if name == "sweep_dtau"
                                       else launches_b5[name])
            if name == "detect":
                row["config5"] = {key: kern_b5[key] for key in (
                    "max_abs_err", "stokes_max_abs_err", "max_err_of_max",
                    "err_of_max", "stokes_v_zero", "ms", "device_ms",
                    "plain_ms", "plain_device_ms", "seven_call_ms",
                    "seven_call_device_ms", "bound_ms", "bound_by", "bytes",
                    "library_ms", "touched_entries", "lit_lanes")}
        if name in k1_modes + RESIDENT + DETECT:
            # the config-6 and config-7 paths (full_width_b6, full_width_b7)
            # and kernels 1, 2 and detect at config 6's first event
            # (kernels_b6)
            for cfg_name, counts in (("config6", launches_b6),
                                     ("config7", launches_b7)):
                row[f"launches_{cfg_name}"] = (
                    sum(counts[m] for m in k1_modes) if name == "sweep_dtau"
                    else counts[name])
            if name in kern_b6:
                row["config6"] = {key: kern_b6[name][key] for key in (
                    "max_abs_err", "max_err_of_tau", "max_err_of_max",
                    "max_tau", "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "active_pairs", "found_lanes",
                    "lanes_outside_grid", "lit_lanes", "touched_entries",
                    "device_launches")
                    if key in kern_b6[name]}
        if name in ("mlsweep_dtau",) + ML + DETECT:
            # the config-4 path (full_width_b4: the Voronoi raster) and
            # kernels 4-5 and detect at its first event (kernels_b4)
            row["launches_config4"] = launches_b4[name]
            if name in kern_b4:
                row["config4"] = {key: kern_b4[name][key] for key in (
                    "max_abs_err", "max_err_of_tau", "err_of_max",
                    "max_err_of_max", "record_bit_identical", "ms",
                    "device_ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "n_groups", "rows", "leaves", "live_share", "fine_grid",
                    "n_steps", "touched_entries", "lit_lanes")
                    if key in kern_b4[name]}
        if name in ("mlsweep_dtau",) + ML + DETECT:
            # disk_tree: geometric sources on a density octree
            row["launches_disk_tree"] = launches_disk_tree[name]
            # the imported snapshots: the AMR mesh and the SPH octree on
            # the tree sweep, kernels 4-5 at amr_galaxy's first event
            row["launches_amr_galaxy"] = launches_amr[name]
            row["launches_sph_galaxy"] = launches_sph[name]
            if name in kern_amr:
                row["amr_galaxy"] = kern_amr[name]
            # the tetrahedral and the relaxed Voronoi rasters: kernels 4-5
            # at their first events (kernels_march_tetra), launched on
            # their full-width runs
            for mesh in ("tetra_galaxy", "voronoi_density"):
                row[f"launches_{mesh}"] = launches_mesh[mesh][name]
                k45 = kern_mesh[mesh]
                if name in k45:
                    row[mesh] = k45[name]
        if name in DETECT:
            row["launches_disk_cyl"] = launches_disk_cyl[name]
        if name in k1_modes + RESIDENT + DETECT + ("sweep_deposit",):
            # config 1h's refill path (refill_b1h)
            row["launches_config1h"] = (sum(launches_1h[m] for m in k1_modes)
                                        if name == "sweep_dtau"
                                        else launches_1h[name])
        rows.append(row)
    # kernels 6-7 on this slice's paths: kernel 7's grouped mode (config 2
    # at 256^3), with the cell map and kernel 6 at a 512^3 tree raster (the
    # level-9 tree)
    for name, counter, ref, path, counts in (
            ("sweepxl_deposit_prefix_grouped", "sweepxl_deposit_prefix", k7,
             "full_width_b2x256", launches_b2x256),
            ("sweepxl_deposit_prefix_cellmap", "sweepxl_deposit_prefix", k7,
             "rf_treexl", launches_rf_treexl),
            ("sweepxl_dtau_prefix_tree512", "sweepxl_dtau_prefix", k6,
             "full_width_treexl", launches_treexl)):
        k = kern[name]
        src = "sweepxl_dtau.cu" if counter == "sweepxl_dtau_prefix" else \
            "sweepxl_deposit.cu"
        rows.append({"name": name, "route": "cuda",
                     "source": f"skirt9_tpu_torch/csrc/{src}",
                     "replaces": ref, "path": path,
                     "launches": counts[counter],
                     **{key: k[key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "device_ms",
                         "fresh_table_device_ms", "err_of_max",
                         "max_err_of_tau", "n_groups", "rows", "rf_cells",
                         "voxels", "touched_entries", "crossed_pairs",
                         "active_pairs") if key in k}})
    for name, src, ref in (
            ("probe_gather_smem", "probe_gather.cu",
             "tools/_pallas_probe.py:12 (gather_kernel) and :34 "
             "(take_kernel)"),
            ("probe_gather_l2", "probe_gather.cu",
             "tools/_pallas_probe.py:12 (gather_kernel)"),
            ("probe_scatter_smem", "probe_gather.cu",
             "tools/_pallas_probe.py:56 (scat_kernel)"),
            ("row_lookup_gather", "row_lookup.cu",
             "tools/bench_sublane_gather.py:26 (kern_gather)"),
            ("row_lookup_select", "row_lookup.cu",
             "tools/bench_sublane_gather.py:38 (kern_select)")):
        k = kern[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"skirt9_tpu_torch/csrc/{src}", "replaces": ref,
                     "path": "kernels_probe (the tool's entry point)",
                     **{key: k[key] for key in (
                         "launches", "max_abs_err", "ms", "plain_ms",
                         "bound_ms", "bound_by", "library_ms", "device_ms",
                         "library_device_ms", "floor_ms", "variants") if key in k}})
    # the scan march: not a TPU kernel (an XLA scan in the reference); its
    # launches on the walk (Voronoi) and on config 1's march paths
    for name, path, counts in (
            ("march_voronoi", "full_width_b4_walk", launches_walk),
            ("march_uniform", "full_width_b1_march",
             launches_b1_march["march_uniform"]),
            ("march_mesh", "full_width_b1_march",
             launches_b1_march["march_mesh"])):
        k = kern_march[name]
        rows.append({"name": name, "route": "cuda",
                     "source": "skirt9_tpu_torch/csrc/march.cu",
                     "replaces": "skirt9_tpu/transport/lifecycle.py:132 "
                     "(march_geometry, an XLA scan: not a TPU kernel)",
                     "path": path, "launches": counts[name],
                     **{key: k[key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "device_ms",
                         "profiler_dropped", "lanes_cells_differ",
                         "ds_sum_rel_err", "live_share")}})
    # its tree modes: the octree on config 3's march (and a level-10
    # octree, checked in kernels_march_tree), the bintree on the reduced
    # bench3 bintree of draw_for_draw_march
    tree_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "device_ms", "profiler_dropped",
                 "lanes_cells_differ", "live_share", "leaves", "levels",
                 "mean_depth", "max_walk")
    for name, path, counts in (
            ("march_octree", "full_width_b3_march", launches_b3_march),
            ("march_bintree", "draw_for_draw_march "
             "(bench3_bintree_explicit_absorption)",
             launches_small["bench3_bintree_explicit_absorption"])):
        k = kern_march[name]
        row = {"name": name, "route": "cuda",
               "source": "skirt9_tpu_torch/csrc/march.cu",
               "replaces": "skirt9_tpu/transport/lifecycle.py:132 "
               "(march_geometry, an XLA scan: not a TPU kernel)",
               "path": path, "launches": counts[name],
               **{key: k[key] for key in tree_keys}}
        if name == "march_octree":
            row["level10"] = {key: kern_march["march_octree_level10"][key]
                              for key in tree_keys}
            row["launches_draw_for_draw_march"] = {
                case: n[name] for case, n in launches_small.items()
                if name in n}
        rows.append(row)
    # the curvilinear modes: the cylinder on disk_cyl, the sphere on the
    # Ivezic gate's run inside full_width_disk_cyl
    for name, path, counts in (
            ("march_cylinder2d", "full_width_disk_cyl", launches_disk_cyl),
            ("march_sphere1d", "full_width_disk_cyl (its Ivezic run)",
             ivezic_launches)):
        k = kern_march[name]
        rows.append({"name": name, "route": "cuda",
                     "source": "skirt9_tpu_torch/csrc/march.cu",
                     "replaces": "skirt9_tpu/transport/lifecycle.py:132 "
                     "(march_geometry, an XLA scan: not a TPU kernel)",
                     "path": path, "launches": counts[name],
                     **{key: k[key] for key in tree_keys + (
                         "cells", "shift", "ds_sum_rel_err") if key in k},
                     "linear_mesh": {
                         key: v for key, v in
                         kern_march[f"{name}_linear"].items()
                         if key in tree_keys},
                     "launches_draw_for_draw_geometric": {
                         case: n[name] for case, n in
                         launches_geo_small.items() if name in n}})
    # the adaptive mesh's mode: amr_galaxy_march's 3 3 3 root on its
    # full-width run, and tests/test_amr.py's meshes
    k = kern_march["march_amr"]
    rows.append({"name": "march_amr", "route": "cuda",
                 "source": "skirt9_tpu_torch/csrc/march.cu",
                 "replaces": "skirt9_tpu/transport/lifecycle.py:132 "
                 "(march_geometry over skirt9_tpu/grids/amr.py:73 "
                 "AMRGrid.step, an XLA scan: not a TPU kernel)",
                 "path": "full_width_amr_march",
                 "launches": launches_amr_march["march_amr"],
                 **{key: k[key] for key in tree_keys},
                 "amr_two_level": {key: kern_march["amr_two_level"][key]
                                   for key in tree_keys},
                 "amr_deep": {key: kern_march["amr_deep"][key]
                              for key in tree_keys},
                 "launches_draw_for_draw_imports": imports_small[
                     "amr_galaxy_march_small"]["launches"]["march_amr"]})
    kern_march["march_tetra_300"] = kern_mesh["march_tetra_300"]
    # the polar modes on their configurations' full-width runs, the
    # tetrahedral mode on tetra_galaxy_march's, each held bit for bit at its
    # first event (kernels_march_polar, kernels_march_tetra)
    for name, path in (("march_sphere2d", "full_width_torus_sphere2d"),
                       ("march_sphere3d", "full_width_spiral_sphere3d"),
                       ("march_cylinder3d", "full_width_spiral_cylinder3d"),
                       ("march_tetra", "full_width_tetra_galaxy_march")):
        k = kern_march[name]
        run = path.replace("full_width_", "")
        rows.append({"name": name, "route": "cuda",
                     "source": "skirt9_tpu_torch/csrc/march.cu",
                     "replaces": "skirt9_tpu/transport/lifecycle.py:132 "
                     "(march_geometry over " + (
                         "skirt9_tpu/grids/tetra.py:84 TetraGrid.step"
                         if name == "march_tetra" else
                         "skirt9_tpu/grids/polar.py " + {
                             "march_sphere2d": ":154 Sphere2DGrid.step",
                             "march_sphere3d": ":265 Sphere3DGrid.step",
                             "march_cylinder3d": ":386 Cylinder3DGrid.step"}[
                                 name]) + ", an XLA scan: not a TPU kernel)",
                     "path": path, "launches": launches_mesh[run][name],
                     **{key: k[key] for key in tree_keys + (
                         "cells", "shift", "ds_sum_rel_err") if key in k},
                     "launches_point_source": (point_launches[run] or {}).get(
                         name, 0),
                     **({"seeded_300_sites": {
                         key: v for key, v in kern_march[
                             "march_tetra_300"].items() if key in tree_keys}}
                        if name == "march_tetra" else {}),
                     "launches_draw_for_draw_meshes": {
                         case: n[name] for case, n in
                         launches_mesh_small.items() if name in n}})
    # the clumpy sphere's mode on clumpy_torus's full-width run, held bit
    # for bit at its first event and on 4,000 clumps (kernels_march_clumpy)
    k = kern_march["march_clumpy"]
    rows.append({"name": "march_clumpy", "route": "cuda",
                 "source": "skirt9_tpu_torch/csrc/march.cu",
                 "replaces": "skirt9_tpu/transport/lifecycle.py:132 "
                 "(march_geometry over skirt9_tpu/grids/clumpy.py:80 "
                 "ClumpySphericalGrid.step, an XLA scan: not a TPU kernel)",
                 "path": "full_width_clumpy_torus",
                 "launches": launches_mesh["clumpy_torus"]["march_clumpy"],
                 **{key: k[key] for key in tree_keys + (
                     "cells", "clumps", "ds_sum_rel_err") if key in k},
                 "launches_point_source": (point_launches["clumpy_torus"]
                                           or {}).get("march_clumpy", 0),
                 "clumps_past_48kb": {key: v for key, v in kern_march[
                     "march_clumpy_global"].items()
                     if key in tree_keys + ("clumps",)},
                 # the central source's rays stall (ROADMAP.md queue C);
                 # the off-centre source's traverse
                 "aimed_source": kern_march["march_clumpy_aimed"]})
    row = next(r for r in rows if r["name"] == "march_sphere1d")
    row["launches_full_width_ivezic_dust"] = launches_ivezic_dust[
        "march_sphere1d"]
    # glibc's sinf and cosf of every launch and scattering direction
    k = kern_sincos["sincos"]
    rows.append({"name": "sincos", "route": "cuda",
                 "source": "skirt9_tpu_torch/csrc/sincos.cu",
                 "replaces": "skirt9_tpu/ops/rng.py:100 and skirt9_tpu/ops/"
                 "phase.py:67-68 (jnp.cos, jnp.sin: XLA's calls of glibc's "
                 "cosf and sinf, not a TPU kernel)",
                 "path": "full_width", "launches": launches["sincos"],
                 **{key: k[key] for key in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "device_ms", "profiler_dropped",
                     "plain_device_launches")}})
    # the HG scattering direction of every scattering
    k = kern_sincos["hg_direction"]
    rows.append({"name": "hg_direction", "route": "cuda",
                 "source": "skirt9_tpu_torch/csrc/sincos.cu",
                 "replaces": "skirt9_tpu/transport/lifecycle.py:314 "
                 "(hg_scatter_direction: XLA's fused loop over skirt9_tpu/"
                 "ops/phase.py's hg_sample_costheta and rotate_direction, "
                 "not a TPU kernel)",
                 "path": "full_width", "launches": launches["hg_direction"],
                 **{key: k[key] for key in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "device_ms", "profiler_dropped",
                     "plain_device_launches")}})
    # XLA's exp, expm1, log and log1p of the interaction depth (every
    # event) and of the march's deposit factor (config 1's march route under
    # dd, its RF stored)
    for name, path, n, ref in (
            ("interaction_depth", "full_width", launches["interaction_depth"],
             "skirt9_tpu/transport/lifecycle.py:286 (sample_interaction_tau "
             "over skirt9_tpu/ops/rng.py:84 expon_cutoff: XLA's expm1, "
             "log1p and exp, not a TPU kernel)"),
            ("deposit_factor", "dd (config 1 on the march route, both "
             "ranks)", dd["launches"]["config1"]["deposit_factor"],
             "skirt9_tpu/transport/lifecycle.py:239-242 (deposit_rf's "
             "-expm1(-dtau) ds / dtau: XLA's expm1, not a TPU kernel)")):
        k = kern_sincos[name]
        rows.append({"name": name, "route": "cuda",
                     "source": "skirt9_tpu_torch/csrc/xla_math.cu",
                     "replaces": ref, "path": path, "launches": n,
                     **{key: k[key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "device_ms",
                         "profiler_dropped", "plain_device_launches")}})
    for name in ("sweepxl_dtau_prefix", "sweepxl_deposit_prefix"):
        # kernels 6-7 on amr_galaxy's 256^3 voxel raster (kernels_amr,
        # with its one XL batch's launches)
        row = next(r for r in rows if r["name"] == name)
        row["amr_galaxy_voxel_raster"] = kern_amr[name]
        row["launches_amr_galaxy_voxel_raster"] = kern_amr[
            "xl_run_launches"].get(name, 0)
    for name in ("sweepxl_tau_total", "sweepxl_dtau_prefix",
                 "sweepxl_deposit_prefix", "detect"):
        # kernels 6-7 and detect's Stokes mode on bench5's tree raster,
        # against their plain versions at its first event
        row = next(r for r in rows if r["name"] == name)
        row["launches_config5_tree"] = launches_b5_tree[name]
        row["config5_tree"] = kern_b5_tree[name]
    for name in ("mlsweep_tau_total", "mlsweep_dtau_prefix"):
        # kernel 4 with polarization on the static bench5 octree
        row = next(r for r in rows if r["name"] == name)
        row["launches_config5_static_tree"] = launches_small[
            "bench5_tree_static"][name]
        row["config5_static_tree"] = kern_b5_tree[f"{name}_static_tree"]
    # the slab march of domain decomposition: march_uniform on one slab of
    # config 1's 32^3 grid over the gathered lanes of both ranks (dd)
    k = dd["config1"]["slab_march"]
    rows.append({"name": "march_uniform_dd_slab", "route": "cuda",
                 "source": "skirt9_tpu_torch/csrc/march.cu",
                 "replaces": "skirt9_tpu/parallel/domain.py:169 "
                 "(_slab_march: march_geometry on a slab, an XLA scan: "
                 "not a TPU kernel)",
                 "path": "dd (two ranks, config 1, both ranks' launches)",
                 "launches": dd["launches"]["config1"]["march_uniform"],
                 "launches_config2": dd["launches"]["config2"][
                     "march_uniform"],
                 **{key: k[key] for key in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "device_ms", "profiler_dropped",
                     "lanes_cells_differ", "live_share", "lanes", "steps")}})
    for name in DETECT + DIRECTIONS:
        row = next(r for r in rows if r["name"] == name)
        row["launches_dd"] = dd["launches"]["config1"][name]
    # kernel 6's record and summed modes and kernel 7's contract mode on
    # their simulation path, domain decomposition on the XL route (dd_xl),
    # held against their plain versions on its first event; kernel 3 on the
    # local instruments' maps (local_instruments)
    for name, mode in (("sweepxl_dtau", "want_sub"),
                       ("sweepxl_dtau_summed", "summed"),
                       ("sweepxl_deposit", "sweep_deposit")):
        row = next(r for r in rows if r["name"] == name)
        row["launches_full_width_xl"] = row["launches"]
        row["path"] = "dd_xl (two ranks, both ranks' launches)"
        row["launches"] = row["launches_dd_xl"] = dd_xl["xl_two_ranks"][
            "modes"][mode]
        row["dd_xl"] = dd_xl["xl_two_ranks"]["kernels"][mode]
    row = next(r for r in rows if r["name"] == "scatter_add")
    row["launches_kernels_probe"] = row["launches"]
    row["path"] = "local_instruments (config 1, three local maps)"
    row["launches"] = row["launches_local_instruments"] = local["launches"][
        "scatter_add"]
    row["launches_local_instruments_config2"] = local["launches2"][
        "scatter_add"]
    row["local_instruments"] = local["scatter_add"]
    emit({"kernels": rows})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
