#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It

  1. checks that CUDA is there, prints the card's name and power limit,
     and builds the kernels from ``athenak_tpu_torch/csrc`` with nvcc;
  2. holds the ghost-fill kernel against its plain version at the 124^3
     blast deck's shapes (128^3 with ghosts), float32 and float64,
     cell and face arrays (the three at once and each alone): bitwise
     equal, one launch a call; it prints each call's ms (CUDA events)
     beside its device us (``torch.profiler``);
  3. holds the stage kernel against its plain version on both RK2 stages
     of the 124^3 blast after initialisation, and of the same blast as
     8 x 62^3 blocks (``POOL_DECK``): float32 within the two-tier
     bound (> 95% of interior cells within 3e-5 of the field scale, all
     within 5e-3), dtmin within rtol 1e-4, floor counts equal; float64
     within 1e-10 of the field scale; it prints the kernel's registers,
     shared memory and spills (ptxas);
  4. drives the main path through the CLI (``athenak_tpu_torch.main``) on
     ``inputs/mhd/blast.athinput`` for 20 cycles, with the launch counts
     set to 0 just before: the stage kernel must launch twice a cycle and
     the fill kernels at least once; the state must be finite, keep
     div(B) at roundoff and conserve mass, and the ``bin`` dumps must
     exist.  Then it times 20 cycles of the kernel path and of the plain
     path (``mhd/use_kernels=false``) with CUDA events after a warm-up
     cycle;
  5. holds the split-stage kernels (``fused_stage3d``, ``fused_ct3d``)
     against their plain versions on both RK2 stages of the 124^3 SR
     blast after initialisation (SR HLLE and SR LLF) and of the 124^3
     Newtonian blast (HLLD): float32 within the two-tier bound on acc,
     the mass fluxes, the face EMFs and the new face fields, float64
     within 1e-10 of the field scale; it times both kernels, their plain
     versions and the SR c2p, and prints ``fused_ct3d``'s device us
     beside its call ms (one device launch a call);
  6. drives the SR main path through the CLI on ``SR_DECK`` (the ``sr``
     case of ``bench.py``, copied here as text) for 10 cycles, with the
     launch counts set to 0 just before: both split-stage kernels must
     launch twice a cycle and the fill kernels at least once; the state
     must be finite, keep div(B) at roundoff and conserve the interior
     sum of D.  Then it times 10 cycles of the kernel path and of the
     plain path with CUDA events after a warm-up cycle.

  7. holds the v1-route kernels against their plain versions on random
     states at the driven-turbulence decks' shapes: ``fused_mega_stage3d``
     (kernel E) on one 128^3 block and on 8 blocks of 64^3 for both RK2
     stages, ``fused_aux3d`` (kernel F) with its periodic wrap on one
     128^3 block and without it on 8 blocks of 64^3, with floors that
     fire: E's values within 1e-6 (float32) or 1e-10 (float64) of the
     field scale; F bitwise (u, w, bcc, the floor counts and dtmin) and
     one launch a call.  It times both kernels and their plain versions,
     prints F's device us beside its call ms and E's ptxas report;
  8. holds the pool fill (kernel G) against its plain version, bitwise,
     float32 and float64, cell and face arrays, on the 8-block pools of
     ``turb8`` (8 x 64^3) and ``pool`` (8 x 62^3), prints its ptxas
     report, and times it beside one ``torch.take`` of every ghost
     cell's donor;
  9. drives three more decks through the CLI for 10 cycles each, with the
     launch counts set to 0 just before, each count checked exactly:
     ``turb1`` (``TURB_DECK``: driven MHD turbulence at 128^3 on one
     block; E and F twice a cycle, the face fill after every E),
     ``turb8`` (the same deck as 8 x 64^3 blocks; E and F twice a cycle,
     G for the faces and for u in every stage) and ``pool``
     (``POOL_DECK``, ``bench.py``'s blast at 124^3 as 8 x 62^3 blocks;
     kernel A twice a cycle, G twice in every stage).  The
     state must be finite, keep div(B) at roundoff and conserve mass; on
     the driven decks the force is finite and one more forcing leaves a
     net momentum below 1e-6 of the total |M|.  Then it times 10 cycles of
     the kernel path and of the plain path of each deck with CUDA events,
     in turns.
 10. holds the Z4c stage kernel (``z4c_stage``) against its plain version
     on the four RK4 coefficient sets at three shapes: ``Z4C_DECK`` (the
     ``z4c`` case of ``bench.py``, copied here as text: 60^3, nghost 2),
     ``inputs/z4c/one_puncture.athinput`` (64^3, nghost 3) and that deck
     as two blocks of 32^3 with nghost 4, each state after
     initialisation with every channel perturbed and a perturbed RK
     register: float32 within 2e-5 and float64 within 1e-10 of
     max(|value|, 1) on interior cells; the outflow fill kernel
     (``z4c_outflow_fill``) bitwise equal to the plain sweeps and to the
     general fill, the pool's sweep fill after the stage within the same
     tolerances.  It times both kernels, their plain versions and, for
     the fill, the replicate pad, and prints the fill's device us beside
     its call ms (one device launch a call);
 11. drives both Z4c decks (``one_puncture.athinput`` in float32)
     through the CLI for 10 cycles, kernel path and plain path
     (``z4c/use_kernels=false``), with the launch counts set to 0 just
     before each run and checked exactly (the stage and the fill four
     times a cycle on RK4, three on RK3; nothing on the plain path): the
     state must be finite, chi above its floor, the lapse at the
     puncture moved by the gauge and inside (0, 1), and the two paths
     within Z4C_PATH_TOL of each other.  It reports each path's
     zone-cycles/s (CUDA events, in turns) and the split of a kernel-path
     cycle into the stage, the fill, accumulate_rk4 and the host;
 12. holds the flux kernel of the general path (``fused_flux_dir``,
     kernel J: PLM, face floors and HLLD for one direction) against its
     plain version, every direction, on ``inputs/mhd/blast_smr.athinput``
     at its full size (``SMR_FULL``: 128^3 root cells in 32^3 blocks,
     120 blocks on two levels) as initialised and after 5 cycles, and on
     ``inputs/mhd/orszag_tang.athinput`` at 1024^2: float32 within the
     two-tier bound of each channel's scale on the faces the update
     reads, float64 within 1e-10; it times each direction and its plain
     version and prints the kernel's ptxas report;
 13. drives both decks through the CLI in float32 for 10 cycles, kernel
     path and plain path (``mhd/use_kernels=false``), with the launch
     counts set to 0 just before each run: kernel J must launch exactly
     once a direction a stage (60 and 40 times) and nothing else, and
     nothing on the plain path; the state must be finite, keep div(B) at
     roundoff on every level and the volume-weighted mass to 1e-5, and
     the two paths within SMR_PATH_TOL of each other.  It reports each
     path's zone-cycles/s over all blocks of all levels (CUDA events, in
     turns) and the split of one SMR stage into its parts;
 14. drives Newtonian hydro through the CLI in float32 for 10 cycles,
     kernel path and plain path (``hydro/use_kernels=false``), launch
     counts set to 0 before each run and checked exactly: ``hturb1``
     (``inputs/hydro/turb.athinput`` at 128^3 on one block; PLM + HLLC,
     driven; kernel B on u at initialisation and once a stage, nothing
     else), ``hturb8`` (the same as 8 x 64^3; kernel G likewise) and
     ``hblast`` (``inputs/hydro/blast_hydro.athinput`` at 256^3; PPM4 +
     HLLC, three ghost cells: no kernel).  The state must be finite and
     keep its mass to 1e-5, one more forcing must leave a net momentum
     below 1e-6 of |M|, and the two paths must be bitwise equal.  It
     reports each path's zone-cycles/s (CUDA events over NCYC_TURNS
     cycles, in turns) and the parts of a cycle;
 15. holds kernel J against its plain version on the 1-D ``bw`` row
     (``inputs/mhd/bw.athinput``, 260 cells with ghosts, with the
     Brio-Wu field under the keys the shock tube reads; as initialised
     and after 5 cycles; float32 two-tier, float64 1e-10) and times it,
     holds kernel A against its plain version on both RK2 stages of the
     ``field_loop3d`` and ``linear_wave_mhd`` states in float64 within
     TAIL_STAGE_TOL of what the stage changed, then drives the
     Newtonian MHD test decks at their shipped sizes through the CLI
     in float32 for 10 cycles, kernel path and plain path, with exact
     launch counts: ``bw``, ``kh2d-lecoanet-mhd``
     (128^2) and ``current_sheet`` (128 x 64) take J once a direction a
     stage; ``field_loop3d`` and ``linear_wave_mhd`` (64 x 32 x 32)
     take kernel A twice a cycle and B; ``linear_wave_mhd`` with LLF,
     the isothermal gas or a passive scalar take only B (no A, C, D, E
     or J: the JAX package's ``use_pallas`` gate).  The state must be
     finite, div(B) kept where the initial field put it, the mass to
     1e-5, and the paths within SMR_PATH_TOL's tiers of what the plain
     path changed from the initial state.
 16. drives this slice's decks: ``inputs/turb/turb.athinput`` (hydro
     PLM + HLLC with first-order flux correction, driven, one ``hst``
     output) as shipped (60^3, float32) and at 128^3 through the CLI for
     10 cycles, kernel path and plain path (``hydro/use_kernels``): B
     exactly once at initialisation and once a stage, the two paths
     bitwise equal in the state and the history file, ``nfofc``
     printed, zone-cycles/s in turns, and the host ms of the FOFC step,
     one ``hst`` row and one ``rst`` file; turb60 again with three
     cells' energy scaled by 1e-12 after initialisation
     (``TURB_POKES``), both paths: B exactly, ``nfofc`` > 0 and equal,
     the paths bitwise equal; the 124^3 blast with
     ``mhd/fofc=true`` and three cells' energy scaled by 1e-12 after
     initialisation (``FOFC_POKES``): J three times a stage, D once, A
     never, exact, ``nfofc`` > 0, the paths within SMR_PATH_TOL's tiers
     of what the plain path changed, zone-cycles/s against the same deck
     without FOFC (kernel A); restart through ``-r`` on the blast
     (kernel A) and the turbulence deck (B, forcing, FOFC): 20 cycles
     straight and 10 + ``-r`` 10 bitwise equal in u (and the face
     field), the history rows after the restart point equal; kernel J
     against its plain version on ``rt2d-mhd`` (68 x 196 with ghosts,
     reflecting x2 walls) in both directions, as initialised and after 5
     cycles, float32 two-tier and float64 1e-10; and the SR hydro decks
     (``inputs/srhydro/mb1``-``mb4``, ``blast_srhyd``, ``kh_srhyd1``),
     ``rt2d``, ``rt2d-mhd`` (also in float32, kernel path, where J runs
     twice a stage, and plain path, within SMR_PATH_TOL's tiers of what
     the plain path changed), ``lw_implode`` (``hst`` + ``vtk``),
     ``slotted_cyl`` and ``advect_hyd`` at their shipped sizes through
     the CLI for 10 cycles: finite, no c2p failure, exact launches,
     wall-clock zone-cycles/s, the host ms of the source terms and of
     one ``vtk`` dump.
 17. drives the adaptive decks through the CLI, kernel path and plain
     path (``<block>/use_kernels``), with the launch counts set to 0
     just before each run and every tree update recorded, each run one
     or two cycles past its last tree update (``AMR_RUNS``):
     ``inputs/mhd/blast_amr.athinput`` as shipped (64^3 root of 16^3
     blocks, the block-pool route: kernel J three times a stage and no
     other kernel, exact), with ``mesh_refinement/block_pool=false``
     (kernel A twice a cycle and kernel G while the tree is flat, J
     three times a stage once it refines, exact for A and J) and at
     128^3 / 32^3 (the full-width run), ``blast_hydro_amr`` as shipped
     (its slope criterion stays below 2.0, the tree flat) and with
     value_max 0.5 (no kernel on either), and
     ``inputs/z4c/one_puncture_amr.athinput`` in float32 (kernel H four
     times a cycle while the tree is flat and never after, kernel I
     never: the deck is a pool): at least one refinement, the same
     leaf sequence on both paths, div(B) <= 1e-5 on every level after
     every tree update and at the end, mass kept to 1e-5, the paths
     within SMR_PATH_TOL's tiers of the plain path's range
     (``range_diff``; the trees of the start and the end differ), chi
     above its floor and the lapse at the puncture in (0, 1); kernel J
     against its plain version on the refined blast's [nmb, 5, 20^3]
     state (f32 two-tier, f64 1e-10) and kernel H on the flat 64 x 8^3
     ng 4 pool (f32 2e-5, f64 1e-10); a ``-r`` restart of
     ``blast_amr`` (28 cycles straight against 14 + ``-r`` 14, bitwise;
     the deck refines first at cycle 12); zone-cycles/s of both paths
     (wall clock of the CLI runs), the host ms of ``check_flags``, ``update_tree``, the
     rebuild and the remap of every tree update, and one stage's parts
     on the refined tree (``smr_stage_parts``).
 18. drives the binary-black-hole decks and the other Z4c decks of
     ``inputs/z4c`` through the CLI, launch counts set to 0 before each
     run and checked exactly: the two-puncture SOR (64^3, 4000
     half-sweeps) timed on the card and, over BBH_SOR_HOST_ITERS
     half-sweeps, in numpy on the host (the two within 1e-12 of
     max|u|); ``bbh_flat`` (``two_puncture_trackers.athinput`` as one
     128^3 block on [-16, 16]^3, the binary under the keys the generator
     reads, BBH_FLAT; f32): kernel H against its plain version on the
     initialised state with noise at [1, 22, 136^3] (f32 2e-5, f64
     1e-10), kernel I bitwise, the ms of ``weyl_scalars`` and
     ``adm_constraints``, 4 cycles on both paths (H and I 4 a cycle on
     the kernel path, nothing on the plain one; the paths within
     Z4C_PATH_TOL, the trackers within 1e-4 of the separation and moved,
     ||H||_2 finite and grown less than 10x); ``bbh_amr`` (the deck as
     shipped in f32, 2 cycles and two tree updates, a waveform row
     every 0.1): the same
     trees on both paths, each
     update one level finer at both trackers, H 4 a cycle while flat,
     the paths within Z4C_PATH_TOL, at least two waveform rows; a ``-r``
     restart of the binary at 64^3 (10 straight against 5 + 5, u and
     co_pos bitwise); ``kerr_schild`` and ``one_puncture_ahf`` as
     shipped in f32 for 4 cycles (H and I once a stage) and ``FastFlow`` on
     ``one_puncture_ahf``'s initial data at ``tests/test_ahf.py``'s
     64^3 on [-2, 2]^3 (M_irr within 0.01 of 1, mean radius within 0.03
     of 1/2); kernel B bitwise on 22 channels at [1, 22, 12, 12, 72]
     and [1, 22, 54^3], H against its plain version at gauge_wave's
     [1, 22, 12, 12, 72] (nghost 4), ``awa/gauge_wave`` in f32 on both
     paths (H 3 a cycle; B's gate takes nghost 2 only, as the JAX
     package's), ``awa/robust_stability`` in f64 (the plain path) and
     in f32 (H 3 a cycle, B once more than that), its noise kept at its
     size.
 19. drives the GR slice and the problem generators' hooks through the
     CLI, the launch counts set to 0 before each run: no kernel may
     launch on any of these decks (GR closes A, C, D, E and J, as the
     JAX package's gates do; none is periodic, which B and G need).
     ``torus124`` (``bench.py``'s ``GR_TORUS_DECK``, copied here as text:
     the FM torus with the SANE loop at 124 x 124 x 64, GRMHD, HLLE,
     FOFC, f32) for 10 cycles with a history row a cycle: the state
     finite, div(B) at roundoff, ``nfofc`` and the c2p counters, the
     flux-sphere columns finite, zone-cycles/s over 5 more cycles (CUDA
     events), the ms of each part of a stage (c2p, fluxes, FOFC, the
     coordinate source terms, corner EMFs + CT, the fills), the device
     launches of a stage (``torch.profiler``) and the peak of
     ``torch.cuda.max_memory_allocated``; ``inputs/grmhd/torus_sane``
     as shipped (60 x 60 x 44), 10 cycles, the same checks; the Bondi
     decks of ``tests/test_gr_bondi.py`` (32^3 to t = 3, RMS-L1 below
     5e-3) and ``tests/test_gr_mhd.py`` (24^3 to t = 2, below 1e-2) in
     f64; the split monopole of ``tests/test_gr_monopole.py`` (32 x 32
     x 16 as 4 blocks, FOFC, t = 4, f64): |<Omega>/Omega_H - 0.5| / 0.5
     below 0.2, its std below 0.12, at least 100 rows, div(B) below
     1e-11; ``inputs/grhydro/bondi``, ``inputs/tests/bondi`` and
     ``inputs/tests/monopole`` as shipped (f64), 5 cycles each;
     ``inputs/tests/gr_monopole.athinput`` as shipped (256 x 256
     x 128 as 2 blocks, nghost 3, f64, FOFC), 2 cycles, the ms of a
     cycle and the peak memory; Bondi at 16^3 in f64, 3 cycles, on the
     card against the port on the CPU within 1e-10 of u's scale;
     ``inputs/mhd/disk_magnetosphere.athinput`` as shipped (f64, 8
     blocks of 32 x 32 x 16, user sides, FOFC, the planet), 10 cycles,
     its history written with the planet's columns; and restarts: the
     torus at 64 x 64 x 32 (10 cycles straight against 5 + ``-r`` 5,
     the history rows after the restart included) and the 32^3 Bondi in
     f64 (the user boundary enrolled again), bitwise.
 20. drives the diffusion and self-gravity slice through the CLI, the
     launch counts set to 0 before each run and checked exactly:
     ``diff_blast`` (``inputs/mhd/blast.athinput`` at 124^3 in f32 with
     ``nu_iso``, ``eta_ohm`` and ``alpha_iso`` 1e-3, 10 cycles: J three
     times a stage, B at every fill, A and D never; the plain path within
     SMR_PATH_TOL's tiers of what it changed; J against its plain version
     on its state, f32 two-tier; the ms of J, each diffusion operator and
     the corner EMFs a stage, the dt limits) and the same without
     ``eta_ohm`` (J and D once a stage); ``inputs/hydro/viscosity`` and
     ``inputs/mhd/resistivity`` as shipped (64 cells, f64) to tlim: the
     decay amplitude within 5% of exp(-coef k^2 t) (the bars of
     ``tests/test_diffusion.py``); ``shock_cloud`` as shipped (160 x 80
     x 80, f64, inflow), 10 cycles, no kernel; ``jeans_wave`` as shipped
     (f64) and at 256 x 128 x 128 in f32 on both paths (B on u and phi,
     1 + 4 a cycle; bitwise paths; the FFT solve's ms), the shipped deck
     to tlim, and ``tests/test_jeans.py``'s stable deck in f64 at 32 and
     64 (its bars); ``selfgravity`` as shipped and at 128^3 on both paths
     (f64: the generator's floor density underflows in f32, so no kernel
     can launch and the two paths are one; V-cycles a solve, ms of a
     solve); ``binary_gravity`` as shipped (64^3 root,
     two refined levels, f64): the verbose solve to 1e-9 in at most 13
     V-cycles and the acceleration L2 error below 1 (the bars of
     ``tests/test_multigrid.py``); ``be_collapse`` as shipped (f64, 20
     cycles, a tree update) and with two ghost cells in f32 on both
     paths (G on u and phi while the tree is flat, 1 + 4 a flat cycle;
     the paths bitwise); ``be_collapse_mhd`` as shipped (f64, 10 cycles,
     its ``bin`` of ``mhd_w``, ``mhd_bcc`` and ``grav_phi`` and its
     ``rst``), in f32 on both paths (J three times a stage; the paths
     within SMR_PATH_TOL's tiers of the plain path's range; J against its
     plain version on its state) and restarted through ``-r`` (10 cycles
     straight against 5 + 5, u, the face field and phi bitwise).
 21. drives the shearing box, particle and ion-neutral slice through the
     CLI, the launch counts set to 0 before each run and checked
     exactly: the nine decks as shipped (``inputs/shearing_box/*``,
     ``inputs/particles/random_drift``, ``inputs/ion-neutral/drag``; f64,
     10 cycles): no launch, div(B) at round-off; ``mri3d_unstratified``
     in f32 and at ``SBOX_WIDE`` (128 x 256 x 64, one block of 2.1M
     cells) on the kernel path (J three times a stage, nothing else) and
     the plain path (nothing), div(B) <= 1e-5, the paths within
     SMR_PATH_TOL's tiers of what they changed, J against its plain
     version on the SBOX_WIDE state (f32 two-tier), the ms of a cycle's
     parts (orbital advection, the sheared remap, J, the source terms, a
     stage, a cycle) and both paths' zone-cycles/s in turns;
     ``random_drift`` in f32 on both paths (B once and once a stage; the
     paths bitwise, the drift exact to 1e-5); ``PART_BLAST``
     (``inputs/mhd/blast.athinput`` with random_drift's ``<particles>``
     block: E and F twice a cycle, the face fill after every E, B once, A
     never; the paths within the tiers); and the JAX tests' bars on the
     card, each on its test's own deck (read from the test file with
     ``ast``) and to its own tlim in f64: the epicyclic oscillation
     (``tests/test_shearing_box.py``), the MHD shearing wave's dByc
     against its table, mean error below 2.1e-8, div(B) below 1e-12
     (``tests/test_shearing_box_mhd.py``), the MRI growth checks of
     ``tests/test_mri3d.py`` and the drag relaxation and stiff drag of
     ``tests/test_ion_neutral.py``.
 22. drives radiation through the CLI, the launch counts set to 0 before
     each run and checked exactly: the five shipped radiation decks
     (``inputs/radiation/{hohlraum_1d,relax,shadow,snake}``,
     ``inputs/tests/rad_linwave``), ``tests/test_rad_gr.py``'s beam in
     Kerr and ``tests/test_radiation.py``'s diffusion deck as they are
     (f64, 5 cycles): no launch, the state finite; ``RAD_WIDE``
     (``rad_linwave`` along x1 at 128^3 on one block in f32: 42 angles,
     GR hydro in flat space, kappa_a 1) and ``RAD_POOL`` (the same as 8 x
     64^3) on the kernel path and the plain path (``hydro/use_kernels``),
     3 cycles: kernel B (one block) or G (the pool) exactly 2 + 6 n times
     in n cycles and no other kernel, the paths bitwise equal in u, w and
     i0, the fill kernel bitwise equal to its plain version on the
     [1, 42, 132^3] and [8, 42, 68^3] intensities with its ms beside the
     plain version's and the bound, the ms of a stage's parts (the
     transport, the coupling, the fluid stage, the fills, a stage, a
     cycle) and both paths' zone-cycles/s in turns; and the JAX tests'
     bars on the card, each on its test's own deck (read with ``ast``)
     in f64: the hohlraum's light front, the relaxation to T^4 + T = 101
     and with Compton to T^4 + T = 11, the shadow, the diffusing pulse
     within 0.08, the beam in Kerr (its energy, centroid and peak), the
     snake's characteristic (nlevel 4, and 8 with the snake-aligned
     tetrad) and the radiating linear wave's convergence (e64 < 6e-7,
     ratio < 0.32; its two sizes, 8,471 launch-bound cycles, run in two
     child lanes).
 23. drives dynamical GRMHD, the launch counts set to 0 before each run
     and checked exactly (no kernel launches anywhere: float64 and
     outflow sides close B and G, the matter source closes H, and the
     MHD stage kernels are closed for the dyngr physics as in the JAX
     package).  ``DYN_WIDE`` (below) runs right after phase 12; in a
     lane: the CUDA graphs of the dyngr stage (the primitive solver,
     the Z4c RHS with the matter source) bitwise equal to the eager
     calls they replay, as captured and on new values; the four shipped
     decks of
     ``inputs/dyn_grmhd/`` as they are (f64) through the CLI, sod,
     tov_cowling and tov_z4c_smr 10 cycles, dynbbh through its first
     tree update (cycle 4) and two cycles past it with its ``hst``
     output and the spacetime rebound to the new tree: states finite,
     div(B) dx / max|B| <= 1e-5 on every level; the JAX tests' bars on
     their own decks (f64): tests/test_dyngr.py's TOV at 24^3 for 30
     cycles (central-density drift < 0.13 fixed, < 0.10 coupled with the
     lapse in (0.1, 1.05)) and its shock tube against the SR MHD tube
     (L1 < 0.005), tests/test_dynbbh.py's lapse minima at t = 0 and a
     quarter orbit later; a restart of tov_cowling (10 cycles against 5
     + ``-r`` 5, bitwise with T).  ``DYN_WIDE``
     (tov_z4c_smr at 64^3 in 32^3 blocks: 64 blocks on level 1, 2.1 M
     cells, f32, coupled Z4c) on both paths for 3 cycles, bitwise equal,
     the ms of a stage's parts (fluxes, coordinate sources, Tmunu, the
     Z4c RHS with matter, the fills, the c2p), the device launches of a
     stage, peak memory and zone-cycles/s in turns.

 24. splits the block axis over ranks (``athenak_tpu_torch.parallel``):
     the ranks are child processes on the card under ``gloo``, every
     rank on ``cuda:0`` with its packed slabs staged through pinned host
     buffers (and the pool deck under ``nccl``, one rank a card, where
     there are cards enough).  In a lane, each against the one-rank run
     of the same deck in the lane's process, launch counts set to 0
     just before each run: ``POOL_DECK`` on 2 and 4 ranks, 10 cycles,
     kernel A on each rank's blocks twice a cycle and G never (one rank
     takes A + G), the state, the time and the floor counts bitwise equal
     (SHA-256 of every leaf); ``blast_smr.athinput`` at ``SMR_FULL`` (120
     blocks) on 4 ranks, 10 cycles, J 3 a stage on every rank, bitwise;
     ``one_puncture.athinput`` in float32 at 128^3 in 64^3 blocks (8
     flat blocks) on 4 ranks, 10 cycles, H 3 a cycle on every rank, I
     never, bitwise; turb8 on 4 ranks, E and F twice a cycle on every
     rank, within test_turb_shard.py's 1e-10 relative (its volume
     integrals are all-reduced in another order; float32 here, so
     within 1e-5 of the field scale); ``blast_amr.athinput`` with
     ``block_pool=false`` on 4 ranks, 20 cycles, the same trees and the
     state bitwise.  In the main process after the lanes: the pool deck
     timed on 1, 2 and 4 ranks (zone-cycles/s over 10 cycles after a
     warm-up cycle, CUDA events on each rank, the slowest rank's), the
     bytes each rank sends a fill of u, the ms of that fill and of one of
     its exchanges.

 25. drives the output tail (the derived-variable registry, ``cbin``,
     ``pdf``, ``cartgrid``, ``sphsurf``, ``log`` and ``-p``) through the
     CLI, each deck on the kernel path, the plain path and the kernel
     path without the new outputs, the launch counts set to 0 before
     each run: the 124^3 blast (20 cycles; ``bin`` of ``mhd_divb``,
     ``mhd_j2``, ``mhd_curv`` and ``mhd_sgs``, a ``cbin`` of
     ``mhd_w_bcc`` with factor 4 and moments, a mass-weighted and a
     joint ``pdf``, a Chebyshev ``cartgrid``, ``sphsurf`` on a log
     ladder, ``log``), the pool (``cbin``), smr 128^3 / 32^3
     (``cartgrid`` and ``sphsurf`` across the levels, ``mhd_divb``),
     turb1 (``turb_force``) and PART_BLAST (``prtcl_d``), 10 cycles each:
     every kernel's launches exactly the deck's without the outputs plus
     one unpack's fills for each extra unpack; the paths' files within
     SMR_PATH_TOL's tiers of the largest change of their channels
     (DERIVED_PATH_TOL for the derived variables), a pdf within
     PDF_PATH_TOL of its weight, the logs' counters equal; on each path
     the pdf weights summing to the domain's volume or mass, the
     sphsurf weights to 4 pi r^2, the cbin block means equal to the bin
     dump's, the cartgrid at eight points equal to a host trilinear
     interpolation of the bin dump, sum(prtcl_d) vol the particle count,
     mhd_divb dx / max|B| <= 1e-5 on every level and equal to
     ``check_levels``', the log's last row the driver's counters; the
     pool on 2 gloo ranks with ``cbin``, a joint ``pdf`` and
     ``mhd_jcon``, rank 0's files byte-equal to one rank's, a trace a
     rank; ``-p`` on the blast for 3 cycles in a fresh process (its trace
     names kernel A's ``stage_kernel`` 6 times and kernel B's
     ``periodic_fill_kernel`` as often as B's wrappers counted).  In the
     main process: the host ms of one write of each of the blast's
     outputs, the card synchronised around it.
 26. the batched cycle window (``Driver._run_window``) on the blast
     124^3, the pool 8 x 62^3, z4c 60^3, the puncture 64^3, smr 128^3 /
     32^3 (f32) and the SR blast, each without its outputs
     (``WIN_DECKS``).  In a lane (``window_checks``): 32 cycles (two
     batches) on each path, the launch counts set to 0 before each run:
     the graphed window one capture and a replay a batch, every kernel's
     launches in the window the replays times the capture's and the
     eager window's, bitwise the eager window
     (SHA-256 of every leaf, time, dt, cycles, counters, launches); the
     SR blast's window eager (its Illinois c2p reads the host); the
     window against the per-cycle loop, float32 within the repo's path
     tiers (SMR_PATH_TOL of the largest change of the state, as phase
     25 scales a file; Z4C_PATH_TOL) and time and dt within
     WIN_TIME_RTOL of the host's float64 chain (F32), float64 bitwise;
     kernels A (blast, pool), E (blast), C and D (SR blast) and H (z4c,
     puncture) given the step as a 0-d tensor on the card against their
     plain versions at the tiers above, and each captured in a CUDA
     graph and replayed on an overwritten step, bitwise its eager launch.
     In the main process: each deck's zone-cycles/s on the per-cycle
     loop, the eager window and the graphed window (16 cycles after a
     warm-up cycle, or batch on the graph path, CUDA events), the
     captures and replays, the ms of
     the copy of the state into the capture's buffers and out of them,
     and the peak memory of each run.
 27. the configurations the JAX package runs on its NamedSharding
     gather path, split over ranks at the widths their decks are timed
     at on one card, each as 8 blocks (``gather_jobs``): JEANS_BIG (the
     FFT, 128 x 64 x 64 blocks), selfgravity 128^3 in float64 (the
     multigrid, 64^3 blocks, 4 cycles), SBOX_WIDE (the shearing box,
     64^3 blocks), AMR_WIDE with its block pool (20 cycles, two tree
     updates), the shipped shadow (the user boundary, 16 x 64 blocks),
     each on 2 gloo ranks on the card, and PART_BLAST (62^3 blocks,
     190,471 particles) on 3.  In a lane (``split_gather``): each run
     bitwise its one-rank run here (SHA-256 of every leaf, time,
     counters, history, trees), every rank's gravity solves and
     V-cycles the one-rank run's, every rank's launches as derived (J
     on the shearing box and the pool, E and F on PART_BLAST as often
     as on one rank; G and I never).  In the main process: each deck's
     zone-cycles/s on one rank and on 2 gloo ranks (NCYC_GATHER_TIMED
     cycles after a warm-up cycle, the slowest rank's), the bytes a rank
     sends a cycle point to point and into all-gathers; with two cards
     or more the decks on one rank a card under nccl, timed and bitwise
     their one-rank runs.
 28. MHD under RK4 (ROADMAP F33).  In a lane (``rk4_checks``): the
     124^3 blast (``inputs/mhd/blast.athinput`` with
     ``time/integrator=rk4``, f32) through the CLI for NCYC_RK4 cycles
     on both paths, kernel A exactly 4 a cycle and B 4 n + 4, the paths
     within the tiers phases 25 and 26 hold the blast to; its window
     (NCYC_WIN cycles: one capture, A 64 a capture) bitwise the eager
     window and within phase 26's tiers of the per-cycle loop; the SR
     blast under RK4 for NCYC_RK4_SR cycles on both paths (C and D 4 a
     cycle) and in its window, which stays eager.  In the main process
     (before the lanes start): the blast's zone-cycles/s under RK2 and
     RK4 on the loop in turns and on the graphed window.
 29. kernel H's matter source (its gate stays the JAX package's, so no
     CLI path launches it; called directly here).  In the main process
     (before the lanes start): DYN_WIDE after one coupled cycle (every
     leaf on level 1, one inverse spacing for every block), H with and
     without the fluid's stress-energy against its plain version on
     the four RK4 stages (2e-5 of max(|value|, 1)), one launch a call,
     its ms beside the vacuum call's on the same state, the plain
     stage's, the eager RHS with matter's (``Z4c._matter_rhs``) and the
     bound; in a lane (``matter_f64``) the same checks in float64 on the
     shipped tov_z4c_smr deck (1e-10).

A run without outputs, verbose, AMR, driving or particles takes the
batched window (``athenak_tpu_torch/driver.py``), from a CUDA graph
where ``Driver.graph_window`` admits it: the launch counts of such runs
in every phase are the graph replays' (each capture's launches added at
every replay), equal to an eager run's.

The runs that time nothing (the JAX tests' bars of phases 19-23, the
restarts of phases 16-19, the Bonnor-Ebert runs, phase 23's graph
checks, shipped decks and restart, phase 24's checks, phase 25's
decks, split pool and ``-p``, phase 26's to 29's checks) run in
``LANES``: child processes on
the card (``chip_smoke.py --lane NAME...``), started once phases 1-12,
DYN_WIDE and phases 29's and 28's timings are done and running beside
phases 13-22.  So the kernels', DYN_WIDE's and phases 28-29's times are
taken alone, phases 13-22's beside the lanes
(launch-bound processes slow each other little on one card: four
copies of the linear wave ran 1.08-1.15x slower than one,
``prof_dyn_graphs.py``).

Every failure raises, so the exit code is not 0.  The last lines of
standard output are the card's name and power limit, one JSON line with
the kernels' numbers and one JSON line ``{"ok": true, "device": {...}}``.
Each kernel's ``bound_ms`` is the least time the card could take for the
same work: the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s and its operations over the
float32 peak of 67 TFLOP/s (H100 SXM data sheet).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(ROOT, "inputs", "mhd", "blast.athinput")
NCYC = 20
NCYC_SR = 10
HBM_BYTES_PER_S = 3.35e12      # H100 SXM
FP32_OPS_PER_S = 67e12         # H100 SXM, outside the tensor cores
# operations per face or cell, counted from the CUDA sources and rounded:
# PLM of 7 channels + face floors, then the Riemann solver
OPS_FACE = {"hlld": 325, "sr_hlle": 375, "sr_llf": 355}
OPS_ACC = 65          # per cell: RK update of 5 channels
OPS_CT = 100          # per cell: 3 GS07 corners + 3 face updates
OPS_MEGA = 1250       # per cell: 2 c2p, 3 HLLD faces, RK, GS07, CT, dt
OPS_AUX = 100         # per cell: bcc, c2p with floors, 3 fast speeds
NCYC_TURB = 10
RK2 = ((0.0, 1.0, 1.0), (0.5, 0.5, 0.5))   # (gam0, gam1, beta) per stage
SMR_DECK = os.path.join(ROOT, "inputs", "mhd", "blast_smr.athinput")
OT_DECK = os.path.join(ROOT, "inputs", "mhd", "orszag_tang.athinput")
# phases 12-13: blast_smr.athinput at its full size, 128^3 root cells in
# 32^3 blocks (120 blocks of 36^3 with ghosts: 56 at level 0, 64 at
# level 1), and the Orszag-Tang deck at 1024^2 on one block
SMR_FULL = ["mesh/nx1=128", "mesh/nx2=128", "mesh/nx3=128",
            "meshblock/nx1=32", "meshblock/nx2=32", "meshblock/nx3=32"]
OT_FULL = ["mesh/nx1=1024", "mesh/nx2=1024"]
NCYC_SMR = 10
# tests/test_torch_cuda.py's small SMR deck: orszag_tang.athinput on a
# 32^2 root grid of 8^2 blocks with one level-1 region (28 blocks)
OT_SMR = ["mesh/nx1=32", "mesh/nx2=32", "meshblock/nx1=8",
          "meshblock/nx2=8", "mesh_refinement/refinement=static",
          "refined_region1/level=1", "refined_region1/x1min=-0.125",
          "refined_region1/x1max=0.125", "refined_region1/x2min=-0.125",
          "refined_region1/x2max=0.125"]
# kernel path (kernel J, face floors on) against the plain path (no face
# floors) after NCYC_SMR cycles in float32, of each field's scale: more
# than 95% of the interior cells within the first, all within the second
SMR_PATH_TOL = (1e-4, 1e-2)
# phase 14: the hydro decks in float32 at full width, 10 cycles a path
HTURB_DECK = os.path.join(ROOT, "inputs", "hydro", "turb.athinput")
HBLAST_DECK = os.path.join(ROOT, "inputs", "hydro", "blast_hydro.athinput")
HTURB1 = ["job/precision=single", "mesh/nx1=128", "mesh/nx2=128",
          "mesh/nx3=128"]
HTURB8 = HTURB1 + ["meshblock/nx1=64", "meshblock/nx2=64",
                   "meshblock/nx3=64"]
HBLAST = ["job/precision=single", "mesh/nx1=256", "mesh/nx2=256",
          "mesh/nx3=256"]
NCYC_HYDRO = 10
# the timed turns of phases 13 and 14 (after a warm-up cycle)
NCYC_TURNS = 5
# phase 15: the Newtonian MHD test decks at their shipped sizes, float32
TAIL_DECKS = {
    "bw": os.path.join(ROOT, "inputs", "mhd", "bw.athinput"),
    "kh2d-mhd": os.path.join(ROOT, "inputs", "mhd",
                             "kh2d-lecoanet-mhd.athinput"),
    "current_sheet": os.path.join(ROOT, "inputs", "mhd",
                                  "current_sheet.athinput"),
    "field_loop3d": os.path.join(ROOT, "inputs", "mhd",
                                 "field_loop3d.athinput"),
    "linear_wave_mhd": os.path.join(ROOT, "inputs", "tests",
                                    "linear_wave_mhd.athinput"),
}
NCYC_TAIL = 10
# the Brio-Wu field under the keys the shock tube reads (the shipped
# bw.athinput spells them bx/by_l/by_r, which it does not read), for
# kernel J's 1-D check: HLLD off its zero-field branch
BW_FIELD = ["problem/bxl=0.75", "problem/byl=1.0", "problem/byr=-1.0"]
# kernel A against its plain version on the 3-D test decks' states in
# float64: |difference| over the plain stage's max|change|
TAIL_STAGE_TOL = 1e-6
# phase 16: AthenaK's own turbulence deck (hydro, FOFC, one hst output;
# 60^3 in float32 as shipped, and at 128^3), the 124^3 blast with FOFC
# and a few cells' energy scaled by 1e-12, restarts, and the SR hydro
# and source-term decks at their shipped sizes
TURB60_DECK = os.path.join(ROOT, "inputs", "turb", "turb.athinput")
TURB128 = ["mesh/nx1=128", "mesh/nx2=128", "mesh/nx3=128"]
NCYC_SLICE = 10
FOFC_POKES = ((64, 64, 64), (40, 70, 90), (100, 30, 50))
# turb60's cells (64^3 with ghosts) whose total energy is scaled by 1e-12
TURB_POKES = ((32, 32, 32), (20, 35, 45), (50, 15, 25))
# kernel J against its plain version on rt2d-mhd: a channel's scale is its
# own max|flux| but at least this share of the direction's largest, so a
# channel that is zero up to rounding (the x1 mass flux of the seed) is
# held on the flux values around it
RT_FLUX_FLOOR = 1e-2
SLICE_DECKS = {
    **{name: os.path.join(ROOT, "inputs", "srhydro", f"{name}.athinput")
       for name in ("mb1", "mb2", "mb3", "mb4", "blast_srhyd",
                    "kh_srhyd1")},
    "rt2d": os.path.join(ROOT, "inputs", "hydro", "rt2d.athinput"),
    "rt2d-mhd": os.path.join(ROOT, "inputs", "mhd", "rt2d-mhd.athinput"),
    "lw_implode": os.path.join(ROOT, "inputs", "hydro",
                               "lw_implode.athinput"),
    "slotted_cyl": os.path.join(ROOT, "inputs", "hydro",
                                "slotted_cyl.athinput"),
    "advect_hyd": os.path.join(ROOT, "inputs", "tests",
                               "advect_hyd.athinput"),
}
PUNCTURE = os.path.join(ROOT, "inputs", "z4c", "one_puncture.athinput")

# phase 17: the adaptive decks
BLAST_AMR = os.path.join(ROOT, "inputs", "mhd", "blast_amr.athinput")
HYDRO_AMR = os.path.join(ROOT, "inputs", "hydro", "blast_hydro_amr.athinput")
Z4C_AMR = os.path.join(ROOT, "inputs", "z4c", "one_puncture_amr.athinput")
AMR_WIDE = ["mesh/nx1=128", "mesh/nx2=128", "mesh/nx3=128",
            "meshblock/nx1=32", "meshblock/nx2=32", "meshblock/nx3=32"]
NCYC_AMR = 16
AMR_NOPOOL = ["mesh_refinement/block_pool=false"]
# blast_amr's flat tree, where kernels A and G are checked: 4 cycles in
AMR_FLAT_CYCLES = 4
# (label, deck, physics block, cycles, overrides); blast_amr's density
# passes value_max 1.5 at cycle 12 at 64^3 (updates at cycles 12 and 14)
# and at cycle 18 at 128^3 (18 and 20): those runs end two cycles after
# their second update; hydro_amr_0.5 refines at cycle 5, z4c_amr at
# cycles 1 and 2: those end one cycle after their last update
AMR_RUNS = [
    ("blast_amr", BLAST_AMR, "mhd", NCYC_AMR, []),
    ("blast_amr_nopool", BLAST_AMR, "mhd", NCYC_AMR, AMR_NOPOOL),
    ("blast_amr_128", BLAST_AMR, "mhd", 22, AMR_WIDE),
    ("hydro_amr", HYDRO_AMR, "hydro", 6, ["job/precision=single"]),
    ("hydro_amr_0.5", HYDRO_AMR, "hydro", 6,
     ["job/precision=single", "amr_criterion1/value_max=0.5"]),
    ("z4c_amr", Z4C_AMR, "z4c", 3, ["job/precision=single"])]
# phase 18: binary black holes and the other Z4c decks of inputs/z4c
BBH = os.path.join(ROOT, "inputs", "z4c", "two_puncture_trackers.athinput")
KERR = os.path.join(ROOT, "inputs", "z4c", "kerr_schild.athinput")
AHF1 = os.path.join(ROOT, "inputs", "z4c", "one_puncture_ahf.athinput")
GAUGE = os.path.join(ROOT, "inputs", "z4c", "awa", "gauge_wave.athinput")
ROBUST = os.path.join(ROOT, "inputs", "z4c", "awa",
                      "robust_stability.athinput")
# the binary under the keys the generator reads (the shipped deck's
# par_* keys are read by neither package: ROADMAP F10), one level
BBH_BINARY = ["problem/punc1_x1=3", "problem/punc2_x1=-3",
              "problem/punc1_P_x2=-0.1", "problem/punc2_P_x2=0.1"]
BBH_FLAT = BBH_BINARY + [
    "mesh_refinement/refinement=none", "z4c/extraction_radius_1=12"] + [
    f"{b}/nx{d}=128" for b in ("mesh", "meshblock") for d in (1, 2, 3)] + [
    f"mesh/x{d}{e}={v}" for d in (1, 2, 3) for e, v in (("min", -16.0),
                                                        ("max", 16.0))]
BBH_RST = [o for o in BBH_FLAT if "nx" not in o] + [
    f"{b}/nx{d}=64" for b in ("mesh", "meshblock") for d in (1, 2, 3)]
# the shipped deck (tracker AMR to level 4), a waveform row every 0.1
BBH_AMR = ["job/precision=single", "output1/dt=0.1"]
NCYC_BBH = 4
# the tracker AMR updates at every cycle: two updates
NCYC_BBH_AMR = 2
NCYC_BBH_RST = 10
NCYC_Z4C_SLICE = 4
# the AwA decks: robust stability's noise is held to its bound after 10
# cycles (it starts above it in f64: 1.1e-8 of 1e-8 after 6)
NCYC_AWA = 10
# numpy's half-sweeps of the SOR timed on the host (30 ms each at 64^3)
BBH_SOR_HOST_ITERS = 100
# tests/test_ahf.py's mesh for the horizon finder: 64^3 on [-2, 2]^3
AHF_FIND = ["mesh/nghost=4"] + [
    f"{b}/nx{d}=64" for b in ("mesh", "meshblock") for d in (1, 2, 3)] + [
    f"mesh/x{d}{e}={v}" for d in (1, 2, 3) for e, v in (("min", -2.0),
                                                        ("max", 2.0))]
NCYC_Z4C = 10
# phase 10's pool: one_puncture.athinput as two blocks of 32^3, nghost 4
Z4C_POOL = ["mesh/nghost=4", "mesh/nx1=64", "mesh/nx2=32", "mesh/nx3=32",
            "meshblock/nx1=32", "meshblock/nx2=32", "meshblock/nx3=32"]
# kernel H's operations (add, subtract, multiply, divide, negate; pow and
# cbrt count one) by nghost: (a cell, the extra on a Sommerfeld cell),
# counted from csrc/z4c_rhs.cuh by tests/test_torch_z4c_host.py
Z4C_OPS = {2: (5563, 264), 3: (7471, 264), 4: (9907, 264), 5: (12871, 264)}
# the operations kernel H's matter source adds a cell (on the Sommerfeld
# mask too: its terms are formed before the rows replace them), counted
# by tests/test_torch_z4c_host.py
Z4C_MATTER_OPS = 92
# channels whose mixed second derivatives kernel H takes (chi, the metric,
# alpha, the shift): the only reads of u's edge ghosts
Z4C_MIXED = 11
# kernel path against plain path after NCYC_Z4C cycles in float32, of
# max(|value|, 1): the two round differently only in AlgConstr's cube
# root (cbrt against x ** (1/3), an ulp), and such differences grow over
# the 30-40 stages without a physical instability to feed on
Z4C_PATH_TOL = 1e-4
# inputs/hydro/turb.athinput's mesh, time and driving blocks at 128^3, with
# <hydro> replaced by <mhd> (PLM, HLLD) and a uniform x1 field b0
# phase 19: the GR slice and the hooks
NCYC_GR = 10
TORUS_SANE = os.path.join(ROOT, "inputs", "grmhd", "torus_sane.athinput")
GR_MONOPOLE = os.path.join(ROOT, "inputs", "tests", "gr_monopole.athinput")
DISK_MAG = os.path.join(ROOT, "inputs", "mhd", "disk_magnetosphere.athinput")
GR_SHIPPED = {"grhydro_bondi": ("grhydro", "bondi.athinput"),
              "tests_bondi": ("tests", "bondi.athinput"),
              "tests_monopole": ("tests", "monopole.athinput")}
GR_ROWS = ["output8/file_type=hst", "output8/dcycle=1",
           "output8/data_format=%.17e"]
TORUS_RST = ["mesh/nx1=64", "mesh/nx2=64", "mesh/nx3=32"]

# bench.py's GR_TORUS_DECK, copied as text
GR_TORUS_DECK = """
<job>
basename = bench_torus
precision = single

<mesh>
nghost = 2
nx1 = 124
x1min = -20.0
x1max = 20.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 124
x2min = -20.0
x2max = 20.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 64
x3min = -10.0
x3max = 10.0
ix3_bc = outflow
ox3_bc = outflow

<coord>
general_rel = true
a = 0.9375
excise = true
dexcise = 1.0e-8
pexcise = 0.333e-10

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 10.0

<mhd>
eos = ideal
gamma = 1.4444444444444444
reconstruct = plm
rsolver = hlle
fofc = true

<problem>
pgen_name = gr_torus
r_edge = 6.0
r_peak = 12.0
b_norm = 0.1
potential_cutoff = 0.2
"""

# tests/test_gr_bondi.py's and tests/test_gr_mhd.py's Bondi decks
GR_BONDI_DECK = """
<job>
basename = gr_bondi

<mesh>
nghost = 2
nx1 = {n}
x1min = -10.0
x1max = 10.0
ix1_bc = user
ox1_bc = user
nx2 = {n}
x2min = -10.0
x2max = 10.0
ix2_bc = user
ox2_bc = user
nx3 = {n}
x3min = -10.0
x3max = 10.0
ix3_bc = user
ox3_bc = user

<coord>
general_rel = true
a = 0.0
excise = true
dexcise = 1.0e-8
pexcise = 0.333e-12

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = {tlim}

<{phys}>
eos = ideal
reconstruct = plm
rsolver = hlle
gamma = 1.3333333333333

<problem>
pgen_name = gr_bondi
k_adi = 1.0
r_crit = 8.0
"""

# tests/test_gr_monopole.py's deck
GR_MONO_TEST_DECK = """
<job>
basename = monopole

<mesh>
nghost = 2
nx1 = 32
x1min = -6.0
x1max = 6.0
ix1_bc = diode
ox1_bc = diode
nx2 = 32
x2min = -6.0
x2max = 6.0
ix2_bc = diode
ox2_bc = diode
nx3 = 16
x3min = 0.0
x3max = 6.0
ix3_bc = diode
ox3_bc = diode

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 16

<coord>
general_rel = true
a = 0.5
excise = true
dexcise = 1.0e-4
pexcise = 0.333e-6

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = -1
tlim = 4.0
ndiag = 100

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlle
gamma = 1.3333333333333
dfloor = 1.0e-6
pfloor = 0.333e-8
fofc = true
gamma_max = 10.0

<problem>
pgen_name = gr_monopole
nlevel = 5
sigma_norm = 5000.0
rhomin = 1.0e-6
umin = 1.0e-8
a_norm = 1.0
"""

TURB_DECK = """
<job>
basename = turb
precision = single

<mesh>
nghost = 2
nx1 = 128
x1min = -0.5
x1max = 0.5
ix1_bc = periodic
ox1_bc = periodic
nx2 = 128
x2min = -0.5
x2max = 0.5
ix2_bc = periodic
ox2_bc = periodic
nx3 = 128
x3min = -0.5
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<turb_driving>
nlow = 1
nhigh = 2
dedt = 0.5
tcorr = 0.5
seed = 1

<problem>
pgen_name = turb
d0 = 1.0
p0 = 1.0
b0 = 0.1
"""
TURB8 = ["meshblock/nx1=64", "meshblock/nx2=64", "meshblock/nx3=64",
         "mesh/coalesce=false"]
# bench.py's DECK as run_config(124, 62, coalesce=False) makes it
POOL_DECK = """
<job>
basename = bench_blast
precision = single

<mesh>
nghost = 2
nx1 = 124
x1min = -1.0
x1max = 1.0
nx2 = 124
x2min = -1.0
x2max = 1.0
nx3 = 124
x3min = -1.0
x3max = 1.0
coalesce = false

<meshblock>
nx1 = 62
nx2 = 62
nx3 = 62

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 10.0

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 100.0
b_amb = 0.1
"""
SR_DECK = """
<job>
basename = bench_srblast
precision = single

<mesh>
nghost = 2
nx1 = 124
x1min = -1.0
x1max = 1.0
nx2 = 124
x2min = -1.0
x2max = 1.0
nx3 = 124
x3min = -1.0
x3max = 1.0

<coord>
special_rel = true

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 10.0

<mhd>
eos = ideal
gamma = 1.3333333333333333
reconstruct = plm
rsolver = hlle

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 5.0
b_amb = 0.1
"""
# bench.py's z4c case (its Z4C_DECK), copied as text
Z4C_DECK = """
<job>
basename = bench_punc
precision = single

<mesh>
nghost = 2
nx1 = 60
x1min = -6.0
x1max = 6.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 60
x2min = -6.0
x2max = 6.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 60
x3min = -6.0
x3max = 6.0
ix3_bc = outflow
ox3_bc = outflow

<time>
evolution = dynamic
integrator = rk4
cfl_number = 0.25
tlim = 100.0

<z4c>
diss = 0.5

<problem>
pgen_name = z4c_one_puncture
punc_ADM_mass = 1.0
"""


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_records(log: str):
    """[(name, registers, static smem bytes, stack and spill text)] from
    nvcc's -Xptxas -v report, one per entry function; the name without
    namespace and argument list."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = short_name(m.group(1))
        elif "spill stores" in line and name:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and name:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, regs, int(smem.group(1)) if smem else 0,
                        spill))
            name, spill = None, ""
    return out


def ptxas_summary(log: str):
    """The report, short: one line for each kernel that spills, one line
    for the rest."""
    out, rest = [], []
    for name, regs, _, spill in ptxas_records(log):
        if spill.startswith("0 bytes stack"):
            rest.append(regs)
        else:
            out.append(f"{name}: {regs} registers, {spill}")
    if rest:
        out.append(f"{len(rest)} other kernels: no stack, no spills, at "
                   f"most {max(rest)} registers")
    return out


def ptxas_lines(log: str):
    """The report, one line per entry function."""
    return [f"{name}: {regs} registers, {smem} bytes static smem, {spill}"
            for name, regs, smem, spill in ptxas_records(log)]


def short_name(mangled: str) -> str:
    """'_ZN7athenak<n>_GLOBAL__N_...11flux_kernelIfLi0EEEv...' ->
    'flux_kernel<f,0>' (enough to tell the launches apart)."""
    import re
    pos, name = mangled.find("N") + 1, None
    while pos and pos < len(mangled) and mangled[pos].isdigit():
        m = re.match(r"\d+", mangled[pos:])
        n = int(m.group(0))
        pos += len(m.group(0))
        name = mangled[pos:pos + n]
        pos += n
    if not pos or name is None:
        return mangled[:60]
    targs = re.match(r"I([fd])((?:Li\d+E)*)", mangled[pos:])
    if not targs:
        return name
    args = [targs.group(1)] + re.findall(r"Li(\d+)E", targs.group(2))
    return f"{name}<{','.join(args)}>"


def print_ptxas(phase: str, source: str) -> None:
    """The ptxas lines of one source's kernels, from this process's
    build of the library."""
    from athenak_tpu_torch import kernels
    log = kernels.BUILD_INFO.get("logs", {}).get(source)
    if log is None:
        print(f"phase {phase}: {source} was built by an earlier process; "
              "no ptxas report")
        return
    for line in ptxas_lines(log):
        print(f"phase {phase}: ptxas {source}: {line}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_split(torch, fn, calls: int):
    """[(kernel name, calls, mean us)] of every device launch of
    ``calls`` calls of fn under torch.profiler (after one call outside
    it), or None if the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev = (getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0) or 0)
        if dev <= 0 or e.key.startswith(("aten::", "cuda", "Profiler",
                                         "Activity Buffer")):
            continue
        name = e.key
        m = re.search(
            r"athenak::(?:\(anonymous namespace\)::)?(\w+<[^>]*>|\w+)", name)
        if m:
            name = m.group(1)
        rows.append((name[:70], e.count, dev / e.count))
    return rows or None


def split_launches(split, calls: int):
    """Device launches a call from ``device_split``'s rows, each kernel's
    count over ``calls`` rounded (late in a long process the profiler
    drops a few records: 19 of 20, 48 of 50), or None."""
    return None if split is None else sum(round(c / calls)
                                          for _, c, _ in split)


def one_launch_split(torch, fn, calls: int, label: str, tries: int = 3):
    """``device_split`` of fn where each call must be one device launch.
    A profile that shows another count is taken again, up to ``tries``
    times in all, since the profiler can drop or misattribute records of
    a whole profile; the check fails if none shows one launch a call,
    with every profile's rows in the message."""
    seen = []
    for _ in range(tries):
        split = device_split(torch, fn, calls)
        if split_launches(split, calls) in (None, 1):
            if seen:
                print(f"{label}: one device launch a call on profile "
                      f"{len(seen) + 1}; earlier profiles {seen}")
            return split
        seen.append(split)
    raise AssertionError(f"{label}: not one device launch a call in "
                         f"{tries} profiles of {calls} calls: {seen}")


def split_us(split, calls: int):
    """Device microseconds a call from ``device_split``'s rows: each
    kernel's mean time times its launches a call (as
    ``split_launches``), or None."""
    return None if split is None else sum(us * round(c / calls)
                                          for _, c, us in split)


def device_us(fn, calls: int):
    """Device microseconds a call of fn() (every launch it makes) under
    torch.profiler, or None where the profiler recorded no device time."""
    import torch
    return split_us(device_split(torch, fn, calls), calls)


def fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.2f} us"


def two_tier(got, ref, scale, label, tight=3e-5, loose=5e-3):
    """>95% of cells within `tight`, all within `loose` (scale-relative);
    returns the max absolute error."""
    import torch
    err = (got.double() - ref.double()).abs()
    rel = err / scale
    frac = float((rel < tight).double().mean())
    if not (frac > 0.95 and float(rel.max()) < loose):
        raise AssertionError(f"{label}: {frac:.4f} of cells within {tight}, "
                             f"max scale-relative error {float(rel.max()):g}")
    return float(err.max())


def interior(t, ng=2):
    """The interior of a cell or face array: ng cells off both ends of
    every axis that has ghosts (a 2-D deck's x3 axis has none)."""
    sl = [slice(None)] * t.dim()
    for ax in range(t.dim() - 3, t.dim()):
        if t.shape[ax] > 2 * ng:
            sl[ax] = slice(ng, -ng)
    return t[tuple(sl)]


def faces(t):
    """Faces [2, n-2] on every axis with ghosts of a cell-indexed face
    quantity: the faces the RK update and the corner EMFs read."""
    sl = [slice(None)] * t.dim()
    for ax in range(t.dim() - 3, t.dim()):
        if t.shape[ax] > 1:
            sl[ax] = slice(2, -1)
    return t[tuple(sl)]


def card_step(torch, x, like):
    """The stage's step as the driver passes it to the kernels (A, C, D,
    E, H read it from device memory): a 0-d tensor of ``like``'s dtype on
    its card."""
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def pin_for(overrides, deck=DECK):
    from athenak_tpu_torch.main import read_deck
    return read_deck(deck, overrides)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes_moved, ops):
    """(bound_ms, bound_by): the larger of memory and arithmetic time."""
    t_mem = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def phase_fill(torch, fill, card):
    """Kernel B against its plain version, bitwise: one launch a call for
    the cell array and for the face field, whole or one array at a
    time."""
    from athenak_tpu_torch import kernels
    gen = torch.Generator().manual_seed(1)
    n = 128
    times = {}
    errs = {"periodic_fill_cc": 0.0, "periodic_fill_fc": 0.0}

    def once(kernel, fn, *args):
        n0 = kernel.launches
        fn(*args)
        if kernel.launches != n0 + 1:
            raise AssertionError(f"{kernel.name}: {kernel.launches - n0} "
                                 "launches in one call")

    for dtype in (torch.float32, torch.float64):
        # the hydro u of hturb1 (phase 14): one block of 128^3 cells
        h = torch.rand((1, 5, 132, 132, 132), generator=gen,
                       dtype=dtype).cuda()
        a, b = h.clone(), h.clone()
        once(kernels.PERIODIC_FILL_CC, fill.periodic_fill_cc, a)
        fill.fill_plain(b, fill.shifts(b.shape))
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"periodic_fill_cc 132^3 {dtype}: not "
                                 "bitwise")
        del h, a, b
        cc = torch.rand((1, 5, n, n, n), generator=gen, dtype=dtype)
        fc = {"x1f": torch.rand((1, n, n, n + 1), generator=gen, dtype=dtype),
              "x2f": torch.rand((1, n, n + 1, n), generator=gen, dtype=dtype),
              "x3f": torch.rand((1, n + 1, n, n), generator=gen, dtype=dtype)}
        cc = cc.cuda()
        fc = {k: v.cuda() for k, v in fc.items()}
        a, b = cc.clone(), cc.clone()
        once(kernels.PERIODIC_FILL_CC, fill.periodic_fill_cc, a)
        fill.fill_plain(b, fill.shifts(b.shape))
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"periodic_fill_cc {dtype}: not bitwise")
        errs["periodic_fill_cc"] = max(errs["periodic_fill_cc"],
                                       float((a - b).abs().max()))
        fa = {k: v.clone() for k, v in fc.items()}
        once(kernels.PERIODIC_FILL_FC, fill.periodic_fill_fc, fa)
        for k, v in fc.items():
            ref = v.clone()
            fill.fill_plain(ref, fill.shifts(ref.shape, k))
            one = {k: v.clone()}
            once(kernels.PERIODIC_FILL_FC, fill.periodic_fill_fc, one)
            if not (torch.equal(fa[k], ref) and torch.equal(one[k], ref)):
                raise AssertionError(f"periodic_fill_fc {k} {dtype}: "
                                     "not bitwise")
            errs["periodic_fill_fc"] = max(errs["periodic_fill_fc"],
                                           float((fa[k] - ref).abs().max()))
        if dtype == torch.float32:
            pad = torch.nn.functional.pad
            # one PyTorch call for the same function, timed as a yardstick
            # only: the circular pad of the interior; for a face array the
            # nx faces [2, nx + 2) of its normal axis are padded 2 below
            # and 3 above (the shared face is owned once)
            cc_int = interior(a)
            if not torch.equal(pad(cc_int, (2,) * 6, mode="circular"), a):
                raise AssertionError("circular pad differs from the fill")
            tr, nrm = slice(2, -2), slice(2, -3)
            fc_int = {"x1f": fa["x1f"][:, tr, tr, nrm],
                      "x2f": fa["x2f"][:, tr, nrm, tr],
                      "x3f": fa["x3f"][:, nrm, tr, tr]}
            fc_int = {k: v.unsqueeze(1) for k, v in fc_int.items()}
            fc_pad = {"x1f": (2, 3, 2, 2, 2, 2), "x2f": (2, 2, 2, 3, 2, 2),
                      "x3f": (2, 2, 2, 2, 2, 3)}
            # ghosts: each read once from its source and written once
            ghost_cc = a.numel() - cc_int.numel()
            ghost_fc = sum(v.numel() - v[:, tr, tr, tr].numel()
                           for v in fa.values())
            times["periodic_fill_cc"] = (
                cuda_ms(lambda: fill.periodic_fill_cc(a), 50),
                cuda_ms(lambda: fill.fill_plain(b, fill.shifts(b.shape)),
                        50),
                cuda_ms(lambda: pad(cc_int, (2,) * 6, mode="circular"), 50),
                bound(2 * ghost_cc * a.element_size(), 0),
                device_us(lambda: fill.periodic_fill_cc(a), 50))
            times["periodic_fill_fc"] = (
                cuda_ms(lambda: fill.periodic_fill_fc(fa), 50),
                cuda_ms(lambda: [fill.fill_plain(v, fill.shifts(v.shape, k))
                                 for k, v in fc.items()], 50),
                cuda_ms(lambda: [pad(fc_int[k], fc_pad[k], mode="circular")
                                 for k in fa], 50),
                bound(2 * ghost_fc * a.element_size(), 0),
                device_us(lambda: fill.periodic_fill_fc(fa), 50))
    tc, tf = times["periodic_fill_cc"], times["periodic_fill_fc"]
    print(f"phase 2: periodic fill kernels bitwise equal to the plain "
          f"version (f32, f64; cells also at [1, 5, 132, 132, 132], the "
          f"hydro hturb1 block), one launch a call; [{card}] cc "
          f"{tc[0]:.4f} "
          f"ms a call, device {fmt_us(tc[4])} (plain {tc[1]:.4f} ms, "
          f"circular pad {tc[2]:.4f} ms, bound {tc[3][0]:.5f} ms), fc "
          f"{tf[0]:.4f} ms a call, device {fmt_us(tf[4])} (plain "
          f"{tf[1]:.4f} ms, circular pad {tf[2]:.4f} ms, bound "
          f"{tf[3][0]:.5f} ms)")
    return times, errs


def fill_plain(phys, u, bfc):
    """(u, bfc) with their ghosts filled by the plain fills: the periodic
    fill on one block, the ordered pool sweeps on a pool."""
    from athenak_tpu_torch.ops import fill, pool_fill
    if phys.mesh.nmb_total == 1:
        return (fill.fill_plain(u, fill.shifts(u.shape)),
                {c: fill.fill_plain(v, fill.shifts(v.shape, c))
                 for c, v in bfc.items()})
    pool_fill.pool_fill_plain([u, *bfc.values()], ["cc", *bfc],
                              phys.bvals.nbr27(), phys.mesh)
    return u, bfc


def phase_stage(torch, card, pool_deck):
    """Kernel A against its plain version on both RK2 stages of the 124^3
    blast and of the pool deck (the same blast as 8 x 62^3 blocks)."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import stage

    result, maxerr = {}, 0.0
    for (label0, deck), prec in ((d, p) for d in (("124^3", DECK),
                                                  ("8 x 62^3", pool_deck))
                                 for p in ("single", "double")):
        mesh, phys, _, driver, state = build(
            pin_for([f"job/precision={prec}"], deck), device="cuda")
        state = phys.unpack_state(driver.initialize(state))
        dt = mesh.dt
        u0, b0 = state["u"], state["bfc"]
        eos, dxs = phys.eos, phys.dxs
        inp_u, inp_b = u0, b0
        for s, (g0, g1, beta) in enumerate(((0.0, 1.0, 1.0),
                                            (0.5, 0.5, 0.5))):
            bdt = torch.tensor(beta, dtype=u0.dtype) \
                * torch.tensor(dt, dtype=u0.dtype)
            args = (inp_u, inp_b, u0, b0, eos, g0, g1,
                    card_step(torch, bdt, u0), dxs)
            uk, bk, ck = stage.mega_stage_v2(*args)
            up, bp, cp = stage.mega_stage_v2_plain(*args)
            torch.cuda.synchronize()
            bscale = max(float(interior(bp[c]).abs().max())
                         for c in bp)
            uscale = interior(up).abs().amax(dim=(-3, -2, -1), keepdim=True)
            label = f"stage {s + 1} {label0} {prec}"
            if prec == "single":
                maxerr = max(maxerr, two_tier(interior(uk), interior(up),
                                              uscale, f"{label} u"))
                for c in bp:
                    maxerr = max(maxerr, two_tier(
                        interior(bk[c]), interior(bp[c]), bscale,
                        f"{label} {c}"))
                for key in ("neos_dfloor", "neos_efloor", "neos_tfloor"):
                    if int(ck[key]) != int(cp[key]):
                        raise AssertionError(f"{label} {key}: "
                                             f"{int(ck[key])} != "
                                             f"{int(cp[key])}")
                rtol = 1e-4
            else:
                err = float(((interior(uk) - interior(up)).abs()
                             / uscale).max())
                berr = max(float((interior(bk[c]) - interior(bp[c])).abs()
                                 .max()) / bscale for c in bp)
                if not (err <= 1e-10 and berr <= 1e-10):
                    raise AssertionError(f"{label}: u err {err:g}, "
                                         f"bfc err {berr:g} > 1e-10")
                rtol = 1e-10
            dk, dp = float(ck["dtmin"]), float(cp["dtmin"])
            if abs(dk - dp) > rtol * abs(dp):
                raise AssertionError(f"{label} dtmin {dk!r} vs {dp!r}")
            # next stage from the plain result, ghosts filled
            inp_u, inp_b = fill_plain(phys, up, bp)
        if prec == "single":
            args = (u0, b0, u0, b0, eos, 0.0, 1.0,
                    card_step(torch, dt, u0), dxs)
            ms = cuda_ms(lambda: stage.mega_stage_v2(*args), 10)
            if deck == DECK:
                plain_ms = cuda_ms(
                    lambda: stage.mega_stage_v2_plain(*args), 3)
                # reads u, bfc, u1, bfc_old; writes u', bfc'
                moved = 3 * nbytes(u0, *b0.values())
                result = {"ms": ms, "plain_ms": plain_ms,
                          "bound": bound(moved, OPS_MEGA
                                         * interior(u0[:, 0]).numel())}
            else:
                result["pool_ms"] = ms
        print(f"phase 3: mega_stage_v2 agrees with its plain version on "
              f"both RK2 stages ({label0}, {prec})")
    result["max_abs_err"] = maxerr
    print_ptxas("3", "mega_stage_v2.cu")
    print(f"phase 3: [{card}] mega_stage_v2 {result['ms']:.3f} ms/stage, "
          f"plain {result['plain_ms']:.3f} ms/stage (f32, 124^3); "
          f"{result['pool_ms']:.3f} ms/stage on 8 x 62^3")
    return result


def timed_cycles(torch, use_kernels: str, deck=DECK, ncyc=NCYC,
                 extra=(), block="mhd") -> float:
    """zone-cycles/s over ncyc cycles after one warm-up cycle."""
    from athenak_tpu_torch.main import build
    mesh, phys, _, driver, state = build(
        pin_for([f"{block}/use_kernels={use_kernels}", *extra], deck),
        device="cuda")
    state = driver.initialize(state)
    cycle = driver.make_cycle_fn()
    dt = mesh.dt
    state, dtnew, _ = cycle(state, dt)
    dt = min(2.0 * dt, driver.cfl_no * float(dtnew))
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(ncyc):
        state, dtnew, _ = cycle(state, dt)
        dt = min(2.0 * dt, driver.cfl_no * float(dtnew))
    t1.record()
    torch.cuda.synchronize()
    sec = t0.elapsed_time(t1) / 1e3
    mbi = mesh.mb_indcs
    return ncyc * mesh.nmb_total * mbi.nx1 * mbi.nx2 * mbi.nx3 / sec


def cli_run(torch, kernels, deck, ncyc, extra=()):
    """Drive ``main.cli`` on ``deck`` for ncyc cycles with the launch
    counts set to 0 just before; returns the counts read just after, the
    run and the files written (name -> the text of a history or text
    file, None for the others)."""
    from athenak_tpu_torch import main as cli_main
    os.environ["ATHENAK_DEVICE"] = "cuda"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_counts()
        try:
            mesh, phys, driver, state = cli_main.cli(
                ["-i", deck, "-d", tmp, f"time/nlim={ncyc}", *extra])
        finally:
            os.chdir(cwd)
        launches = {k.name: k.launches for k in kernels.ALL}
        written = {}
        for f in sorted(os.listdir(tmp)):
            written[f] = None
            if f.endswith((".hst", ".txt")):
                with open(os.path.join(tmp, f)) as fh:
                    written[f] = fh.read()
    if mesh.ncycle != ncyc:
        raise AssertionError(f"{mesh.ncycle} cycles run, {ncyc} asked")
    return launches, mesh, phys, driver, state, written


def run_cli(torch, kernels, deck, ncyc, extra=()):
    """``cli_run`` with the relative change of the interior sum of
    u[IDN] (the deck's ghost depth off every side) over the run, from a
    build of its initial state: returns the counts, the run, that change
    and the files written."""
    from athenak_tpu_torch.main import build

    mesh0, _, _, _, state0 = build(pin_for(list(extra), deck),
                                   device="cuda")
    ng = mesh0.mb_indcs.ng
    mass0 = float(interior(state0["u"][:, 0], ng).double().sum())
    del state0
    launches, mesh, phys, driver, state, written = cli_run(
        torch, kernels, deck, ncyc, extra)
    mass = float(interior(state["u"][:, 0], ng).double().sum())
    return (launches, mesh, phys, driver, state, abs(mass - mass0) / mass0,
            written)


def check_state(torch, phys, state, dmass, label) -> float:
    """Finite state, max|div B| dx / max|B| <= 1e-5 and the interior sum
    of u[IDN] kept to 1e-5; returns the div(B) measure."""
    u, bfc = state["u"], state["bfc"]
    if not (bool(torch.isfinite(u).all())
            and all(bool(torch.isfinite(v).all()) for v in bfc.values())):
        raise AssertionError(f"{label}: non-finite state")
    b1, b2, b3 = bfc["x1f"], bfc["x2f"], bfc["x3f"]
    div = ((b1[..., 1:] - b1[..., :-1]) / phys.dxs["x1"]
           + (b2[..., 1:, :] - b2[..., :-1, :]) / phys.dxs["x2"]
           + (b3[:, 1:] - b3[:, :-1]) / phys.dxs["x3"])
    bmax = max(float(v.abs().max()) for v in bfc.values())
    divb = float(interior(div).abs().max()) * phys.dxs["x1"] / bmax
    if divb > 1e-5:
        raise AssertionError(f"{label}: max|div B| dx / max|B| = {divb:g} "
                             "> 1e-5")
    if dmass > 1e-5:
        raise AssertionError(f"{label}: interior sum of D changed by "
                             f"{dmass:g} (relative)")
    return divb


def phase_main(torch, kernels, card):
    """The main path through the CLI, with its checks and timings."""
    launches, mesh, phys, driver, state, dmass, written = run_cli(
        torch, kernels, DECK, NCYC)
    bins = [f for f in written if f.endswith(".bin")]
    ncyc = mesh.ncycle
    if launches["mega_stage_v2"] != 2 * ncyc:
        raise AssertionError(f"mega_stage_v2 launched "
                             f"{launches['mega_stage_v2']} times in "
                             f"{ncyc} cycles")
    for name in ("periodic_fill_cc", "periodic_fill_fc"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    divb = check_state(torch, phys, state, dmass, "main path")
    if not bins:
        raise AssertionError("no bin output written")
    print(f"phase 4: main path {ncyc} cycles, launches {launches}, "
          f"div(B) {divb:.3e}, mass drift {dmass:.3e}, bin files {bins}; "
          f"[{card}] CLI zone-cycles/s {driver.zcps:.6e} "
          f"(wall clock, first cycle included)")
    rates = {}
    for label in ("true", "false", "true", "false"):
        rates.setdefault(label, []).append(timed_cycles(torch, label))
    print(f"phase 4: [{card}] zone-cycles/s over {NCYC} cycles after a "
          f"warm-up, kernel path {rates['true']}, plain path "
          f"{rates['false']} (CUDA events)")
    return launches, rates



def phase_split(torch, card, sr_deck):
    """Kernels C and D against their plain versions on both RK2 stages:
    SR HLLE and SR LLF on the SR blast, HLLD on the Newtonian blast."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import fill, stage_split

    err = {"fused_stage3d": 0.0, "fused_ct3d": 0.0}
    res = {}
    cases = (("sr_hlle", sr_deck, []), ("sr_llf", sr_deck,
                                        ["mhd/rsolver=llf"]),
             ("hlld", DECK, []))
    for solver, deck, extra in cases:
        for prec in ("single", "double"):
            mesh, phys, _, driver, state = build(
                pin_for(extra + [f"job/precision={prec}"], deck),
                device="cuda")
            state = phys.unpack_state(driver.initialize(state))
            if phys.stage_solver != solver:
                raise AssertionError(f"{solver}: the deck gives "
                                     f"{phys.stage_solver}")
            u0, b0 = state["u"], state["bfc"]
            inp = (state["w"], state["bcc"], b0, u0)
            for s, (g0, g1, beta) in enumerate(RK2):
                bdt = card_step(torch, torch.tensor(beta, dtype=u0.dtype)
                                * torch.tensor(mesh.dt, dtype=u0.dtype),
                                u0)
                w, bcc, bfc, u = inp
                sargs = (w, bcc, bfc, u, u0, phys.eos, g0, g1, bdt,
                         phys.dxs, solver)
                ka, kf, ke = stage_split.fused_stage3d(*sargs)
                pa, pf, pe = stage_split.fused_stage3d_plain(*sargs)
                pf = {d: v.contiguous() for d, v in pf.items()}
                # kernel D on the plain fluxes and EMFs, so that it is
                # held alone against its plain version
                cargs = (w, bcc, pf, pe, bfc, b0, g0, g1, bdt, phys.dxs)
                kb = stage_split.fused_ct3d(*cargs, is_sr=phys.is_sr)
                pb = stage_split.fused_ct3d_plain(*cargs, is_sr=phys.is_sr)
                torch.cuda.synchronize()
                label = f"{solver} stage {s + 1} {prec}"
                uscale = interior(pa).abs().amax(dim=(-3, -2, -1),
                                                 keepdim=True)
                fscale = max(max(float(faces(v).abs().max())
                                 for v in pf.values()), 1e-30)
                escale = max(max(float(faces(v).abs().max())
                                 for v in pe.values()), 1e-30)
                bscale = max(float(interior(v).abs().max())
                             for v in pb.values())
                pairs = ([("acc", interior(ka), interior(pa), uscale)]
                         + [(f"fden[{d}]", faces(kf[d]), faces(pf[d]),
                             fscale) for d in pf]
                         + [(f"emf[{e}]", faces(ke[e]), faces(pe[e]),
                             escale) for e in pe])
                ct_pairs = [(c, interior(kb[c]), interior(pb[c]), bscale)
                            for c in pb]
                for kernel, group in (("fused_stage3d", pairs),
                                      ("fused_ct3d", ct_pairs)):
                    for name, got, ref, scale in group:
                        if prec == "single":
                            err[kernel] = max(err[kernel], two_tier(
                                got, ref, scale, f"{label} {name}"))
                        else:
                            rel = float(((got - ref).abs() / scale).max())
                            if rel > 1e-10:
                                raise AssertionError(
                                    f"{label} {name}: {rel:g} > 1e-10")
                # the next stage starts from the plain result
                un = fill.fill_plain(pa, fill.shifts(pa.shape))
                bn = {c: fill.fill_plain(v, fill.shifts(v.shape, c))
                      for c, v in pb.items()}
                bccn = phys.compute_bcc(bn)
                wn, un, _ = phys.cons_to_prim(un, bccn)
                inp = (wn, bccn, bn, un)
            print(f"phase 5: fused_stage3d and fused_ct3d agree with their "
                  f"plain versions on both RK2 stages ({solver}, {prec})")
            if prec == "single" and solver == "sr_hlle":
                res = time_split(torch, stage_split, phys, state, mesh.dt)
    res["fused_stage3d"]["max_abs_err"] = err["fused_stage3d"]
    res["fused_ct3d"]["max_abs_err"] = err["fused_ct3d"]
    launched = res["fused_ct3d"]["device_launches"]
    if launched not in (None, 1):
        raise AssertionError(f"fused_ct3d: {launched} device launches a "
                             "call")
    for name in ("fused_stage3d", "fused_ct3d"):
        r = res[name]
        dev = (f", device {fmt_us(r['device_us'])} a call"
               if "device_us" in r else "")
        print(f"phase 5: [{card}] {name} {r['ms']:.4f} ms/stage{dev}, plain "
              f"{r['plain_ms']:.4f} ms/stage, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}) (f32, SR HLLE, 124^3)")
    print(f"phase 5: [{card}] SR c2p (cons_to_prim_sr_mhd, 25 + 25 "
          f"Illinois trips) {res['c2p_ms']:.4f} ms/call (f32, 128^3 "
          f"cells with ghosts)")
    return res


def time_split(torch, stage_split, phys, state, dt):
    """Times of kernels C and D, their plain versions and the SR c2p on
    the first RK2 stage of the SR blast, with each kernel's bound."""
    w, bcc, bfc, u = state["w"], state["bcc"], state["bfc"], state["u"]
    dt = card_step(torch, dt, u)
    sargs = (w, bcc, bfc, u, u, phys.eos, 0.0, 1.0, dt, phys.dxs,
             "sr_hlle")
    acc, fden, emf = stage_split.fused_stage3d(*sargs)
    cargs = (w, bcc, fden, emf, bfc, bfc, 0.0, 1.0, dt, phys.dxs)
    nb = stage_split.fused_ct3d(*cargs, is_sr=True)
    ncell = w[:, 0].numel()
    # gam0 == 0: u0 is not read; reads w, bcc, faces, u1
    moved_c = (nbytes(w, bcc, *bfc.values(), u)
               + nbytes(acc, *fden.values(), *emf.values()))
    ops_c = (3 * OPS_FACE["sr_hlle"] + OPS_ACC) * ncell
    # reads the 3 velocity channels of w, bcc, fluxes, EMFs, 2 x faces
    moved_d = (nbytes(w) * 3 // 5 + nbytes(bcc, *fden.values(),
                                           *emf.values())
               + 2 * nbytes(*bfc.values()) + nbytes(*nb.values()))
    def ct():
        return stage_split.fused_ct3d(*cargs, is_sr=True)

    ct_split = device_split(torch, ct, 20)
    return {
        "fused_stage3d": {
            "ms": cuda_ms(lambda: stage_split.fused_stage3d(*sargs), 20),
            "plain_ms": cuda_ms(
                lambda: stage_split.fused_stage3d_plain(*sargs), 3),
            "bound": bound(moved_c, ops_c)},
        "fused_ct3d": {
            "ms": cuda_ms(ct, 20),
            "plain_ms": cuda_ms(
                lambda: stage_split.fused_ct3d_plain(*cargs, is_sr=True), 3),
            "bound": bound(moved_d, OPS_CT * ncell),
            "device_us": split_us(ct_split, 20),
            "device_launches": split_launches(ct_split, 20)},
        "c2p_ms": cuda_ms(lambda: phys.cons_to_prim(u, bcc), 3)}


def phase_sr_main(torch, kernels, card, sr_deck):
    """The SR main path through the CLI, with its checks and timings."""
    launches, mesh, phys, driver, state, dmass, _ = run_cli(
        torch, kernels, sr_deck, NCYC_SR)
    ncyc = mesh.ncycle
    for name in ("fused_stage3d", "fused_ct3d"):
        if launches[name] != 2 * ncyc:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {ncyc} cycles of the SR path")
    for name in ("periodic_fill_cc", "periodic_fill_fc"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the SR path")
    if launches["mega_stage_v2"]:
        raise AssertionError("mega_stage_v2 launched on the SR path")
    divb = check_state(torch, phys, state, dmass, "SR path")
    print(f"phase 6: SR path {ncyc} cycles, launches {launches}, "
          f"div(B) {divb:.3e}, drift of the interior sum of D {dmass:.3e}, "
          f"nc2p_fail {driver.ecounters['nc2p_fail']}, counters "
          f"{driver.ecounters}; [{card}] CLI zone-cycles/s "
          f"{driver.zcps:.6e} (wall clock, first cycle included)")
    rates = {}
    for label in ("true", "false", "true", "false"):
        rates.setdefault(label, []).append(
            timed_cycles(torch, label, sr_deck, NCYC_SR))
    print(f"phase 6: [{card}] SR zone-cycles/s over {NCYC_SR} cycles after "
          f"a warm-up, kernel path {rates['true']}, plain path "
          f"{rates['false']} (CUDA events)")
    return launches, rates


def random_mhd(torch, gen, nmb, n, dtype, bimodal=False):
    """Random primitives, face field and bcc of nmb blocks of n^3 cells
    (ghosts included) on the card.  ``bimodal`` draws density and
    pressure from [0.2, 0.4] or [0.6, 1.5], so floors at 0.5 fire on a
    share of the cells and no value lies within rounding of them."""
    from athenak_tpu_torch.physics.mhd import compute_bcc

    def r(lo, hi, *shape):
        x = torch.rand(shape, generator=gen, dtype=torch.float64)
        return lo + (hi - lo) * x

    def pos(*shape):
        if not bimodal:
            return r(0.5, 1.5, *shape)
        low = torch.rand(shape, generator=gen, dtype=torch.float64) < 0.3
        return torch.where(low, r(0.2, 0.4, *shape), r(0.6, 1.5, *shape))

    cell = (nmb, n, n, n)
    w = torch.stack([pos(*cell), r(-0.5, 0.5, *cell), r(-0.5, 0.5, *cell),
                     r(-0.5, 0.5, *cell), pos(*cell)], dim=1)
    bfc = {"x1f": r(-0.5, 0.5, nmb, n, n, n + 1),
           "x2f": r(-0.5, 0.5, nmb, n, n + 1, n),
           "x3f": r(-0.5, 0.5, nmb, n + 1, n, n)}
    w = w.to("cuda", dtype)
    bfc = {k: v.to("cuda", dtype) for k, v in bfc.items()}
    return w, bfc, compute_bcc(bfc)


def check_pair(torch, got, ref, scale, label, f32):
    """Every value within 1e-6 (float32) or 1e-10 (float64) of the scale:
    kernels E and F repeat their plain versions' operations in order.
    Returns the max absolute error."""
    tol = 1e-6 if f32 else 1e-10
    err = (got.double() - ref.double()).abs()
    rel = float((err / scale).max())
    if not rel <= tol:                     # NaN fails too
        raise AssertionError(f"{label}: {rel:g} of the scale > {tol:g}")
    return float(err.max())


def phase_mega_v1(torch, card):
    """Kernel E against its plain version on both RK2 stages of random
    states at the driven decks' shapes: one 128^3 block (turb1) and 8
    blocks of 64^3 (turb8), ghosts included."""
    from athenak_tpu_torch.ops import stage_v1
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd

    eos = EOSData()
    err, res, pool_ms = 0.0, {}, None
    for dtype, (nmb, n) in ((d, s) for d in (torch.float32, torch.float64)
                            for s in ((1, 132), (8, 68))):
        nx = n - 4
        dxs = {"x1": 1 / nx, "x2": 1 / nx, "x3": 1 / nx}
        gen = torch.Generator().manual_seed(11)
        w, bfc, bcc = random_mhd(torch, gen, nmb, n, dtype)
        w1, bfc1, bcc1 = random_mhd(torch, gen, nmb, n, dtype)
        u0 = prim_to_cons_mhd(w, bcc, eos)
        u1 = prim_to_cons_mhd(w1, bcc1, eos)
        f32 = dtype == torch.float32
        for s, (g0, g1, beta) in enumerate(RK2):
            args = (w, bcc, bfc, u0, u1, bfc1, eos, g0, g1,
                    card_step(torch, beta * 0.1 / nx, u0), dxs)
            uk, bk = stage_v1.fused_mega_stage3d(*args)
            up, bp = stage_v1.fused_mega_stage3d_plain(*args)
            torch.cuda.synchronize()
            label = f"mega_stage_v1 stage {s + 1} {nmb} x {nx}^3 {dtype}"
            uscale = interior(up).abs().amax(dim=(-3, -2, -1), keepdim=True)
            bscale = max(float(interior(v).abs().max()) for v in bp.values())
            e = check_pair(torch, interior(uk), interior(up), uscale,
                           f"{label} u", f32)
            for c in bp:
                e = max(e, check_pair(torch, interior(bk[c]),
                                      interior(bp[c]), bscale,
                                      f"{label} {c}", f32))
            if f32:
                err = max(err, e)
            if f32 and nmb > 1 and g1 != 0.0:
                pool_ms = cuda_ms(lambda: stage_v1.fused_mega_stage3d(*args),
                                  10)
            elif f32:
                # reads w, bcc, bfc, u0 (+ u1, bfc_old); writes u', bfc'
                moved = nbytes(w, bcc, *bfc.values(), u0, uk, *bk.values())
                if g1 != 0.0:
                    moved += nbytes(u1, *bfc1.values())
                ops = (3 * OPS_FACE["hlld"] + OPS_ACC + OPS_CT) \
                    * interior(u0[:, 0]).numel()
                res[s] = {
                    "ms": cuda_ms(lambda: stage_v1.fused_mega_stage3d(*args),
                                  10),
                    "plain_ms": cuda_ms(
                        lambda: stage_v1.fused_mega_stage3d_plain(*args), 3),
                    "bound": bound(moved, ops)}
        print(f"phase 7: fused_mega_stage3d agrees with its plain version on "
              f"both RK2 stages ({dtype}, {nmb} x {nx}^3 random)")
    for s in res:
        print(f"phase 7: [{card}] fused_mega_stage3d stage {s + 1} "
              f"{res[s]['ms']:.4f} ms, plain {res[s]['plain_ms']:.4f} ms, "
              f"bound {res[s]['bound'][0]:.4f} ms ({res[s]['bound'][1]}) "
              f"(f32, 128^3)")
    print(f"phase 7: [{card}] fused_mega_stage3d stage 2 {pool_ms:.4f} ms "
          f"(f32, 8 x 64^3)")
    print_ptxas("7", "mega_stage_v1.cu")
    # the entry reports the second stage, which reads the RK register
    return dict(res[1], max_abs_err=err, stage1_ms=res[0]["ms"],
                pool_ms=pool_ms)


def phase_aux(torch, card):
    """Kernel F against its plain version, bitwise (u, w, bcc, the floor
    counts and dtmin), one launch a call: with its wrap on one random
    128^3 block, without it on 8 random blocks of 64^3; floors at 0.5 fire
    on a share of the cells."""
    from athenak_tpu_torch import kernels
    from athenak_tpu_torch.ops import aux
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd

    eos = EOSData(dfloor=0.5, pfloor=0.5)
    err, res = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        for wrap, nmb, n in ((True, 1, 132), (False, 8, 68)):
            gen = torch.Generator().manual_seed(12)
            w, bfc, bcc = random_mhd(torch, gen, nmb, n, dtype, bimodal=True)
            u = prim_to_cons_mhd(w, bcc, EOSData())
            dxs = {"x1": 1 / (n - 4), "x2": 1 / (n - 4), "x3": 1 / (n - 4)}
            args = (u, bfc, eos, dxs, wrap)
            n0 = kernels.FUSED_AUX3D.launches
            ku = aux.fused_aux3d(*args)
            if kernels.FUSED_AUX3D.launches != n0 + 1:
                raise AssertionError("fused_aux3d: not one launch a call")
            pu = aux.fused_aux3d_plain(*args)
            torch.cuda.synchronize()
            label = f"fused_aux3d wrap={wrap} {dtype}"
            for name, a, b in zip(("u", "w", "bcc"), ku[:3], pu[:3]):
                if not torch.equal(a, b):
                    raise AssertionError(f"{label} {name}: not bitwise")
                if f32:
                    err = max(err, float((a - b).abs().max()))
            kc, pc = ku[3], pu[3]
            for key in ("neos_dfloor", "neos_efloor", "neos_tfloor",
                        "dtmin"):
                if not torch.equal(kc[key], pc[key]):
                    raise AssertionError(f"{label} {key}: {kc[key]!r} vs "
                                         f"{pc[key]!r}")
            if not (int(pc["neos_dfloor"]) and int(pc["neos_efloor"])):
                raise AssertionError(f"{label}: the floors never fired")
            if f32:
                # reads u and the face field; writes u, w and bcc
                moved = nbytes(u, *bfc.values(), *ku[:3])
                res[wrap] = {
                    "ms": cuda_ms(lambda: aux.fused_aux3d(*args), 20),
                    "device_us": device_us(lambda: aux.fused_aux3d(*args),
                                           20),
                    "plain_ms": cuda_ms(lambda: aux.fused_aux3d_plain(*args),
                                        3),
                    "bound": bound(moved, OPS_AUX * u[:, 0].numel()),
                    "counts": {k: int(kc[k]) for k in kc if k != "dtmin"}}
        print(f"phase 7: fused_aux3d bitwise equal to its plain version, "
              f"one launch a call, wrap on 1 x 128^3 and off on 8 x 64^3 "
              f"({dtype}); counts {res[True]['counts']} and "
              f"{res[False]['counts']}")
    for wrap in res:
        r = res[wrap]
        print(f"phase 7: [{card}] fused_aux3d wrap={wrap} {r['ms']:.4f} ms a "
              f"call, device {fmt_us(r['device_us'])}, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})")
    # the entry reports the wrap of the single 128^3 block (turb1)
    return dict(res[True], max_abs_err=err, nowrap_ms=res[False]["ms"],
                nowrap_device_us=res[False]["device_us"])


def pool_mesh(deck, extra):
    from athenak_tpu_torch.mesh import Mesh
    return Mesh(pin_for(list(extra), deck))


def ghost_donors(torch, pool_fill, shape, kind, nbr, mesh):
    """(dst, src): flat indices of every ghost element of an array and of
    the interior element it copies, read off the plain fill of arange."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)
    filled = idx.clone()
    pool_fill.pool_fill_plain([filled], [kind], nbr, mesh)
    dst = (filled != idx).reshape(-1).nonzero().squeeze(1)
    return dst, filled.reshape(-1)[dst]


def pool_fill_pair(torch, mesh, label):
    """Kernel G against its plain version, bitwise, on the pool of
    ``mesh``: random cell and face arrays in f32 and f64.  Returns the
    largest difference, the neighbour table and the f32 arrays after the
    kernel's fill."""
    from athenak_tpu_torch.ops import pool_fill

    nbr = torch.as_tensor(pool_fill.neighbor27(mesh), device="cuda")
    nmb, n = mesh.nmb_total, mesh.mb_indcs.ncells1
    shapes = {"cc": (nmb, 5, n, n, n), "x1f": (nmb, n, n, n + 1),
              "x2f": (nmb, n, n + 1, n), "x3f": (nmb, n + 1, n, n)}
    maxerr, kept = 0.0, None
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator().manual_seed(13)
        arrs = {k: torch.rand(v, generator=gen, dtype=dtype).cuda()
                for k, v in shapes.items()}
        got = {k: v.clone() for k, v in arrs.items()}
        pool_fill.pool_fill_cc(got["cc"], nbr, mesh)
        pool_fill.pool_fill_fc({k: got[k] for k in ("x1f", "x2f", "x3f")},
                               nbr, mesh)
        ref = {k: v.clone() for k, v in arrs.items()}
        pool_fill.pool_fill_plain(list(ref.values()), list(ref), nbr, mesh)
        torch.cuda.synchronize()
        for k in arrs:
            if not torch.equal(got[k], ref[k]):
                raise AssertionError(f"pool_fill {label} {k} {dtype}: "
                                     "not bitwise")
            maxerr = max(maxerr, float((got[k] - ref[k]).abs().max()))
        if dtype == torch.float32:
            kept = got
    return maxerr, nbr, kept


def pool_fill_times(torch, mesh, nbr, arrs):
    """Kernel G's times on a pool (u, then the face field), its plain
    version's, one torch.take of every ghost's donor, and the bound
    (every ghost read once and written once)."""
    from athenak_tpu_torch.ops import pool_fill

    u = arrs["cc"]
    fcs = {k: arrs[k] for k in ("x1f", "x2f", "x3f")}
    dst, src = ghost_donors(torch, pool_fill, tuple(u.shape), "cc",
                            nbr.cpu(), mesh)
    dst, src = dst.cuda(), src.cuda()
    if not torch.equal(torch.take(u, src), u.reshape(-1)[dst]):
        raise AssertionError("the donor index differs from the pool fill")
    return {
        "ms": cuda_ms(lambda: pool_fill.pool_fill_cc(u, nbr, mesh), 50),
        "fc_ms": cuda_ms(lambda: pool_fill.pool_fill_fc(fcs, nbr, mesh),
                         50),
        "plain_ms": cuda_ms(lambda: pool_fill.pool_fill_plain(
            [u], ["cc"], nbr, mesh), 20),
        "library_ms": cuda_ms(lambda: torch.take(u, src), 50),
        "bound": bound(2 * dst.numel() * u.element_size(), 0),
        "ghosts": dst.numel()}


def phase_pool_fill(torch, card, turb_deck, pool_deck):
    """Kernel G against its plain version, bitwise, on the pools of turb8
    and pool; times on turb8 beside one torch.take of every ghost."""
    res, maxerr = {}, 0.0
    for label, deck, extra in (("turb8", turb_deck, TURB8),
                               ("pool", pool_deck, []),
                               ("hturb8", HTURB_DECK, HTURB8)):
        mesh = pool_mesh(deck, extra)
        err, nbr, arrs = pool_fill_pair(torch, mesh, label)
        maxerr = max(maxerr, err)
        if label == "turb8":
            res = pool_fill_times(torch, mesh, nbr, arrs)
        print(f"phase 8: pool_fill bitwise equal to its plain version on "
              f"{label} ({mesh.nmb_total} x {mesh.mb_indcs.nx1}^3; f32, "
              f"f64; cell and face arrays)")
    print_ptxas("8", "pool_fill.cu")
    print(f"phase 8: [{card}] pool_fill of u on turb8 {res['ms']:.4f} ms "
          f"({res['ghosts']} ghosts), of the face field "
          f"{res['fc_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
          f"torch.take of every donor {res['library_ms']:.4f} ms, bound "
          f"{res['bound'][0]:.5f} ms")
    res["max_abs_err"] = maxerr
    return res


def check_forcing(torch, phys, state, mesh, label) -> float:
    """The force is finite; one more forcing leaves a net interior
    momentum below 1e-6 of the total |M|.  Returns that ratio."""
    if not bool(torch.isfinite(state["turb_force"]).all()):
        raise AssertionError(f"{label}: non-finite force")
    forced = phys.pturb.apply(state, mesh.dt, phys)
    mom = interior(forced["u"][:, 1:4]).double()
    ratio = float(mom.sum(dim=(0, 2, 3, 4)).abs().max() / mom.abs().sum())
    if ratio > 1e-6:
        raise AssertionError(f"{label}: net momentum {ratio:g} of the total "
                             "after forcing")
    return ratio


def stage_parts(torch, phys, state, mesh) -> dict:
    """ms per call of each piece of a cycle on the deck's own state: the
    forcing, the stage kernel, bcc + c2p and the fills (the launch counts
    say how often a cycle calls each)."""
    from athenak_tpu_torch.ops import aux, stage, stage_v1

    u, bfc, dt = state["u"], state["bfc"], mesh.dt
    bv = phys.bvals
    parts = {"fill_fc": cuda_ms(lambda: phys.fill_ghosts_fc(bfc), 20)}
    if phys.pturb is not None:
        parts["forcing"] = cuda_ms(
            lambda: phys.pturb.apply(state, dt, phys), 5)
        parts["mega_stage_v1"] = cuda_ms(lambda: stage_v1.fused_mega_stage3d(
            state["w"], state["bcc"], bfc, u, u, bfc, phys.eos, 0.5, 0.5,
            card_step(torch, 0.5 * dt, u), phys.dxs), 10)
        parts["fused_aux3d"] = cuda_ms(lambda: aux.fused_aux3d(
            u, bfc, phys.eos, dxs=phys.dxs, wrap=bv.use_fill_kernel), 20)
    else:
        parts["mega_stage_v2"] = cuda_ms(lambda: stage.mega_stage_v2(
            u, bfc, u, bfc, phys.eos, 0.5, 0.5, card_step(torch, 0.5 * dt, u),
            phys.dxs), 10)
    if not bv.use_fill_kernel:
        parts["fill_cc"] = cuda_ms(lambda: bv.fill_ghosts(u), 20)
    return parts


def phase_turb_main(torch, kernels, card, turb_deck, pool_deck):
    """turb1, turb8 and pool through the CLI, with their checks and
    timings."""
    out = {}
    runs = (("turb1", turb_deck, []), ("turb8", turb_deck, TURB8),
            ("pool", pool_deck, []))
    for label, deck, extra in runs:
        launches, mesh, phys, driver, state, dmass, _ = run_cli(
            torch, kernels, deck, NCYC_TURB, extra)
        n = mesh.ncycle
        # Fills: one of the faces after every stage (one launch a call
        # for all three face arrays), and on a pool one of u too;
        # initialisation fills u and the faces once, and on the kernel-A
        # pool, whose cycle state holds no primitives, twice more (the
        # first dt and the final state).
        expect = {"turb1": {"mega_stage_v1": 2 * n, "fused_aux3d": 2 * n,
                            "periodic_fill_fc": 2 * n + 1,
                            "periodic_fill_cc": 1, "mega_stage_v2": 0,
                            "pool_fill": 0},
                  "turb8": {"mega_stage_v1": 2 * n, "fused_aux3d": 2 * n,
                            "pool_fill": 4 * n + 2, "mega_stage_v2": 0,
                            "periodic_fill_fc": 0, "periodic_fill_cc": 0},
                  "pool": {"mega_stage_v2": 2 * n, "pool_fill": 4 * n + 6,
                           "mega_stage_v1": 0, "fused_aux3d": 0,
                           "periodic_fill_fc": 0,
                           "periodic_fill_cc": 0}}[label]
        for name, count in expect.items():
            if launches[name] != count:
                raise AssertionError(f"{label}: {name} launched "
                                     f"{launches[name]} times in {n} cycles, "
                                     f"not {count}")
        divb = check_state(torch, phys, state, dmass, label)
        mom = check_forcing(torch, phys, state, mesh, label) \
            if phys.pturb is not None else None
        parts = stage_parts(torch, phys, state, mesh)
        print(f"phase 9: {label} {n} cycles, launches {launches}, div(B) "
              f"{divb:.3e}, mass drift {dmass:.3e}, net momentum after "
              f"forcing {mom}, counters {driver.ecounters}; [{card}] CLI "
              f"zone-cycles/s {driver.zcps:.6e} (wall clock, first cycle "
              f"included)")
        del state
        rates = {}
        for use in ("true", "false", "true", "false"):
            rates.setdefault(use, []).append(
                timed_cycles(torch, use, deck, NCYC_TURB, extra))
        mbi = mesh.mb_indcs
        zones = mesh.nmb_total * mbi.nx1 * mbi.nx2 * mbi.nx3
        cycle_ms = [zones / r * 1e3 for r in rates["true"]]
        print(f"phase 9: [{card}] {label} zone-cycles/s over {NCYC_TURB} "
              f"cycles after a warm-up, kernel path {rates['true']}, plain "
              f"path {rates['false']} (CUDA events); kernel-path cycle "
              f"{cycle_ms} ms; ms per call on the deck's state {parts}")
        out[label] = {"launches": launches, "rates": rates, "parts": parts,
                      "cycle_ms": cycle_ms}
    return out


def z4c_inputs(torch, deck, extra, prec):
    """The deck's state after initialisation on the card, plus 1e-3 N on
    every channel (so the shift, zero in the initial data, takes both
    signs), and a register u1 = u (1 + 1e-3 N); drawn in float64 from a
    seeded generator, then cast to the run's dtype."""
    from athenak_tpu_torch.main import build
    mesh, phys, _, driver, st = build(
        pin_for([f"job/precision={prec}", *extra], deck), device="cuda")
    st = driver.initialize(st)
    dev = st["u"].device
    gen = torch.Generator(device=dev).manual_seed(17)

    def noise():
        return torch.randn(st["u"].shape, generator=gen, device=dev,
                           dtype=torch.float64)

    u = st["u"].double() + 1e-3 * noise()
    u1 = u * (1.0 + 1e-3 * noise())
    dtype = st["u"].dtype
    return phys, u.to(dtype), u1.to(dtype), mesh.dt


def rk4_sets(torch, dtype, dt):
    """(gam0, gam1, beta * dt) of the four RK4 stages, beta * dt rounded
    to ``dtype`` as the driver rounds it and passed as it passes it: a
    0-d tensor on the card."""
    from athenak_tpu_torch.driver import make_integrator
    rk = make_integrator("rk4")
    return [(rk.gam0[s], rk.gam1[s],
             torch.full((), float(rk.beta[s]), dtype=dtype, device="cuda")
             * torch.full((), float(dt), dtype=dtype, device="cuda"))
            for s in range(4)]


def z4c_bound(phys, u, matter=False):
    """Kernel H's bound on ``u``, each value it needs moved once: u on
    the interior and the face ghost slabs (the dissipation and advection
    stencils reach nghost along each axis) and, for the Z4C_MIXED
    channels, the edge bands (nghost - 1)^2 deep that the mixed
    derivatives reach; u1 read and u' written on the interior; the
    Sommerfeld mask read on the interior and the other four geometry
    channels on the mask's cells.  Z4C_OPS operations a cell, and the
    Sommerfeld rows' extra on the mask's cells.  With ``matter`` the
    matter source's ten channels read on the interior and its
    Z4C_MATTER_OPS a cell too."""
    mbi = phys.mesh.mb_indcs
    nx, ng = (mbi.nx1, mbi.nx2, mbi.nx3), phys.ng
    nmb, nch = u.shape[0], u.shape[1]
    cells = nx[0] * nx[1] * nx[2]
    face_ghosts = 2 * ng * (nx[1] * nx[2] + nx[0] * nx[2] + nx[0] * nx[1])
    edge_ghosts = 4 * sum(nx) * (ng - 1) ** 2
    values = nmb * (nch * (cells + face_ghosts) + Z4C_MIXED * edge_ghosts
                    + 2 * nch * cells)
    n_mask = 0
    if phys.sbc_mask is not None:
        n_mask = int(phys.sbc_mask.sum())
        values += nmb * cells + 4 * n_mask
    base, somm = Z4C_OPS[ng]
    if matter:
        values += 10 * nmb * cells
        base += Z4C_MATTER_OPS
    return bound(values * u.element_size(),
                 base * nmb * cells + somm * n_mask)


def outflow_fill_bound(phys, u):
    """Kernel I's bound on ``u``: every ghost written once, and every
    cell of the one-cell interior shell that the ghosts copy read once."""
    mbi = phys.mesh.mb_indcs
    nx = (mbi.nx1, mbi.nx2, mbi.nx3)
    cells = nx[0] * nx[1] * nx[2]
    shell = cells - math.prod(n - 2 for n in nx)
    planes = u.shape[0] * u.shape[1]
    ghosts = math.prod(u.shape[-3:]) - cells
    return bound(planes * (ghosts + shell) * u.element_size(), 0)


def phase_z4c_stage(torch, card, z4c_deck):
    """Kernel H against its plain version on the four RK4 stages at three
    shapes, f32 and f64; kernel I against the sweeps; times at each
    shape."""
    from athenak_tpu_torch.ops import z4c_stage as zs
    pad = torch.nn.functional.pad
    shapes = (("60^3 ng 2", z4c_deck, []), ("64^3 ng 3", PUNCTURE, []),
              ("2 x 32^3 ng 4", PUNCTURE, Z4C_POOL))
    err, fill_err, res = 0.0, 0.0, {}
    for label, deck, extra in shapes:
        for prec in ("single", "double"):
            phys, u, u1, dt = z4c_inputs(torch, deck, extra, prec)
            ng, f32 = phys.ng, prec == "single"
            tol = 2e-5 if f32 else 1e-10
            worst = 0.0
            for g0, g1, bdt in rk4_sets(torch, u.dtype, dt):
                got = zs.fused_z4c_stage(u, u1, phys, g0, g1, bdt)
                want = zs.fused_z4c_stage_plain(u, u1, phys, g0, g1, bdt)
                torch.cuda.synchronize()
                a = interior(got, ng).double()
                b = interior(want, ng).double()
                rel = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                if not rel <= tol:             # NaN fails too
                    raise AssertionError(f"z4c_stage {label} {prec}: "
                                         f"{rel:g} > {tol:g}")
                worst = max(worst, rel)
                if f32:
                    err = max(err, float((a - b).abs().max()))
                if phys.fold_bc:
                    # kernel I on the kernel's stage, against its plain
                    # version, the sweep fill: bitwise and finite
                    k = zs.outflow_fill(got.clone(), phys.bvals)
                    p = phys.bvals.fill_ghosts(got.clone())
                    if not (torch.equal(k, p)
                            and bool(torch.isfinite(k).all())):
                        raise AssertionError(f"z4c_outflow_fill {label} "
                                             f"{prec}: not bitwise or not "
                                             f"finite")
                    fill_err = max(fill_err, float((k - p).abs().max()))
                else:
                    # the pool's route: the sweep fill after the stage
                    kf = phys.bvals.fill_ghosts(got).double()
                    pf = phys.bvals.fill_ghosts(want).double()
                    rel = float(((kf - pf).abs()
                                 / pf.abs().clamp(min=1.0)).max())
                    if not (rel <= tol and bool(torch.isfinite(kf).all())):
                        raise AssertionError(f"z4c pool fill {label} "
                                             f"{prec}: {rel:g} > {tol:g}")
            print(f"phase 10: z4c_stage agrees with its plain version on the "
                  f"four RK4 stages ({label}, {prec}): max scale-relative "
                  f"error {worst:.3e}")
            if not f32:
                continue
            args = (u, u1, phys) + rk4_sets(torch, u.dtype, dt)[1]
            r = {"ms": cuda_ms(lambda: zs.fused_z4c_stage(*args), 20),
                 "plain_ms": cuda_ms(
                     lambda: zs.fused_z4c_stage_plain(*args), 2),
                 "bound": z4c_bound(phys, u)}
            if phys.fold_bc:
                a = zs.outflow_fill(zs.fused_z4c_stage(*args), phys.bvals)
                ai = interior(a, ng)
                if not torch.equal(pad(ai, (ng,) * 6, mode="replicate"), a):
                    raise AssertionError("replicate pad differs from the "
                                         "outflow fill")
                fill_split = one_launch_split(
                    torch, lambda: zs.outflow_fill(a, phys.bvals), 50,
                    "z4c_outflow_fill")
                r["fill"] = {
                    "device_us": split_us(fill_split, 50),
                    "ms": cuda_ms(lambda: zs.outflow_fill(a, phys.bvals), 50),
                    "plain_ms": cuda_ms(
                        lambda: phys.bvals.fill_ghosts(a), 20),
                    "library_ms": cuda_ms(
                        lambda: pad(ai, (ng,) * 6, mode="replicate"), 50),
                    "bound": outflow_fill_bound(phys, a)}
            res[label] = r
    for label, r in res.items():
        print(f"phase 10: [{card}] z4c_stage {label} {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})")
        if "fill" in r:
            f = r["fill"]
            print(f"phase 10: [{card}] z4c_outflow_fill {label} "
                  f"{f['ms']:.4f} ms, device {fmt_us(f['device_us'])}, "
                  f"plain {f['plain_ms']:.4f} ms, "
                  f"replicate pad {f['library_ms']:.4f} ms, bound "
                  f"{f['bound'][0]:.5f} ms")
    return {"res": res, "max_abs_err": err, "fill_max_abs_err": fill_err}


def lapse_at_puncture(u):
    """alpha on the 8 cells around the centre of a single block (the
    puncture sits at the origin, a cell corner)."""
    c = u.shape[-1] // 2
    return u[0, 18, c - 1:c + 1, c - 1:c + 1, c - 1:c + 1].double()


def phase_z4c_main(torch, kernels, card, z4c_deck):
    """Both Z4c decks through the CLI for NCYC_Z4C cycles, kernel path and
    plain path, with their checks, rates and the split of a cycle."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import z4c_stage as zs
    out = {}
    for label, deck, extra, nstage in (
            ("z4c", z4c_deck, [], 4),
            ("puncture", PUNCTURE, ["job/precision=single"], 3)):
        _, phys0, _, _, st0 = build(pin_for(extra, deck), device="cuda")
        alpha0 = lapse_at_puncture(st0["u"])
        runs = {}
        for use in ("true", "false"):
            launches, mesh, phys, driver, state, _, _ = run_cli(
                torch, kernels, deck, NCYC_Z4C,
                extra + [f"z4c/use_kernels={use}"])
            n = mesh.ncycle
            expect = {k: 0 for k in launches}
            if use == "true":
                expect["z4c_stage"] = nstage * n
                expect["z4c_outflow_fill"] = nstage * n
            if launches != expect:
                raise AssertionError(f"{label} use_kernels={use}: launches "
                                     f"{launches}, not {expect}")
            u = state["u"]
            if not bool(torch.isfinite(u).all()):
                raise AssertionError(f"{label}: non-finite state")
            chi_min = float(interior(u[:, 0], phys.ng).min())
            if chi_min < phys.opt.chi_min_floor:
                raise AssertionError(f"{label}: chi {chi_min} below floor")
            # 1+log slicing moves the precollapsed lapse at the puncture
            # (within the first half M it rises there, in the JAX
            # package as here); it stays in (0, 1)
            alpha = lapse_at_puncture(u)
            moved = float(((alpha - alpha0).abs() / alpha0).min())
            if not (moved > 1e-3 and bool((alpha > 0).all())
                    and bool((alpha < 1).all())):
                raise AssertionError(f"{label}: the lapse at the puncture "
                                     f"{alpha.flatten().tolist()} from "
                                     f"{alpha0.flatten().tolist()}")
            runs[use] = (launches, mesh, phys, driver, state)
        a, b = runs["true"][4]["u"].double(), runs["false"][4]["u"].double()
        diff = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
        if not diff <= Z4C_PATH_TOL:
            raise AssertionError(f"{label}: kernel and plain paths part by "
                                 f"{diff:g} > {Z4C_PATH_TOL:g}")
        launches, mesh, phys, driver, state = runs["true"]
        alpha = lapse_at_puncture(state["u"])
        print(f"phase 11: {label} {mesh.ncycle} cycles, launches {launches}; "
              f"chi >= {chi_min:.4e}; lapse at the puncture "
              f"{float(alpha0.mean()):.5f} -> {float(alpha.mean()):.5f}; "
              f"kernel vs plain path {diff:.3e}; [{card}] CLI zone-cycles/s "
              f"{driver.zcps:.6e} (wall clock, first cycle included)")
        # the split of a cycle: ms per call on the run's own state
        u = state["u"]
        dt = mesh.dt
        step = card_step(torch, 0.5 * dt, u)
        parts = {"z4c_stage": cuda_ms(lambda: zs.fused_z4c_stage(
                     u, u, phys, 0.5, 0.5, step), 20),
                 "z4c_outflow_fill": cuda_ms(
                     lambda: zs.outflow_fill(u, phys.bvals), 50)}
        if nstage == 4:
            parts["accumulate_rk4"] = cuda_ms(lambda: phys.accumulate_rk4(
                {"u1": u}, {"u": u}, 0.2), 50)
        del state, runs
        # the plain path (some 5,000 torch launches a stage) is timed
        # once: it is the slowest part of the script
        rates = {}
        for use in ("true", "false", "true"):
            rates.setdefault(use, []).append(timed_cycles(
                torch, use, deck, NCYC_Z4C, extra, block="z4c"))
        mbi = mesh.mb_indcs
        zones = mbi.nx1 * mbi.nx2 * mbi.nx3
        cycle_ms = [zones / r * 1e3 for r in rates["true"]]
        device_ms = nstage * (parts["z4c_stage"] + parts["z4c_outflow_fill"]) \
            + (nstage - 1) * parts.get("accumulate_rk4", 0.0)
        parts["host_and_glue"] = [c - device_ms for c in cycle_ms]
        print(f"phase 11: [{card}] {label} zone-cycles/s over {NCYC_Z4C} "
              f"cycles after a warm-up, kernel path {rates['true']}, plain "
              f"path {rates['false']} (CUDA events); kernel-path cycle "
              f"{cycle_ms} ms; ms per call {parts}")
        out[label] = {"launches": launches, "rates": rates, "parts": parts,
                      "cycle_ms": cycle_ms, "path_diff": diff}
    return out


def deck_state(torch, deck, extra, prec, ncyc=0):
    """(state with w and bcc, phys) of a deck on the card after
    initialisation and ``ncyc`` cycles of the kernel path."""
    from athenak_tpu_torch.main import build
    mesh, phys, _, driver, state = build(
        pin_for([f"job/precision={prec}", *extra], deck), device="cuda")
    state = driver.initialize(state)
    cycle, dt = driver.make_cycle_fn(), mesh.dt
    for _ in range(ncyc):
        state, dtnew, _ = cycle(state, dt)
        dt = min(2.0 * dt, driver.cfl_no * float(dtnew))
    return phys.unpack_state(state), phys


def phase_flux_dir(torch, card):
    """Kernel J against its plain version on the SMR deck's state at
    128^3 / 32^3 (as initialised and after 5 cycles) and on the
    Orszag-Tang deck at 1024^2, per direction: float32 within the
    two-tier bound of each channel's scale, float64 within 1e-10; f32
    times of the initial states."""
    from athenak_tpu_torch.ops import flux
    maxerr, res = 0.0, {}
    cases = (("smr", SMR_FULL, SMR_DECK, 0), ("smr 5 cycles", SMR_FULL,
                                               SMR_DECK, 5),
             ("ot", OT_FULL, OT_DECK, 0))
    for label, extra, deck, ncyc in cases:
        for prec in ("single", "double"):
            state, phys = deck_state(torch, deck, extra, prec, ncyc)
            w, bcc, bfc = state["w"], state["bcc"], state["bfc"]
            del state
            for name, _axis, ivx, _dx in phys.dirs:
                args = (w, bcc, bfc[f"{name}f"], phys.eos, name, ivx)
                got = flux.fused_flux_dir(*args)
                ref = flux.flux_dir_plain(*args)
                torch.cuda.synchronize()
                tag = f"{label} {prec} {name}"
                pairs = [(got[0][:, c], ref[0][:, c], f"flux {c}")
                         for c in range(5)]
                pairs += [(got[1], ref[1], "ey"), (got[2], ref[2], "ez")]
                for g, r, what in pairs:
                    g, r = faces(g), faces(r)
                    scale = float(r.abs().max()) or 1.0
                    if prec == "single":
                        maxerr = max(maxerr, two_tier(g, r, scale,
                                                      f"{tag} {what}"))
                    else:
                        err = float((g - r).abs().max()) / scale
                        if err > 1e-10:
                            raise AssertionError(f"{tag} {what}: {err:g}")
                if prec == "single" and ncyc == 0:
                    cells = w[:, 0].numel()
                    for _ in range(10):  # clocks up after host-bound work
                        flux.fused_flux_dir(*args)
                    res.setdefault(label, {})[name] = {
                        "ms": cuda_ms(lambda: flux.fused_flux_dir(*args),
                                      20),
                        "plain_ms": cuda_ms(
                            lambda: flux.flux_dir_plain(*args), 3),
                        # w (5), the two transverse bcc channels and
                        # the normal field read; flux (5), ey, ez
                        # written: 15 values a face
                        "bound": bound(15 * cells * w.element_size(),
                                       OPS_FACE["hlld"] * cells),
                        "cells": cells}
            del w, bcc, bfc, got, ref
        print(f"phase 12: fused_flux_dir agrees with its plain version on "
              f"{label} (f32 two-tier, f64 1e-10; every direction)")
    for label, dirs in res.items():
        print(f"phase 12: [{card}] fused_flux_dir on {label} "
              f"({next(iter(dirs.values()))['cells']} cells): " + "; ".join(
                  f"{d} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                  f"{r['bound'][0]:.4f} by {r['bound'][1]})"
                  for d, r in dirs.items()))
    print_ptxas("12", "flux_dir.cu")
    smr = res["smr"]
    return {"max_abs_err": maxerr, "by_deck": res,
            "ms": sum(r["ms"] for r in smr.values()) / len(smr),
            "plain_ms": sum(r["plain_ms"] for r in smr.values()) / len(smr),
            "bound": smr["x1"]["bound"]}


def volume_mass(torch, mesh, u):
    """The interior integral of u[IDN], each block weighted by its cell
    volume (float64)."""
    ms = mesh.mb_size
    dv = torch.as_tensor(ms["dx1"] * ms["dx2"] * ms["dx3"], device=u.device)
    return float((interior(u[:, 0]).double().sum(dim=(1, 2, 3)) * dv)
                 .sum())


def check_levels(torch, mesh, state, label):
    """Finite state and max|div B| dx / max|B| <= 1e-5 on every level
    that holds blocks; returns that measure per level."""
    u, bfc = state["u"], state["bfc"]
    if not (bool(torch.isfinite(u).all())
            and all(bool(torch.isfinite(v).all()) for v in bfc.values())):
        raise AssertionError(f"{label}: non-finite state")
    dx = {d: torch.as_tensor(mesh.mb_size[f"d{d}"], device=u.device,
                             dtype=u.dtype).reshape(-1, 1, 1, 1)
          for d in ("x1", "x2", "x3")}
    b1, b2, b3 = bfc["x1f"], bfc["x2f"], bfc["x3f"]
    div = ((b1[..., 1:] - b1[..., :-1]) / dx["x1"]
           + (b2[..., 1:, :] - b2[..., :-1, :]) / dx["x2"])
    if b3.shape[1] > 2:
        div = div + (b3[:, 1:] - b3[:, :-1]) / dx["x3"]
    div = (interior(div).abs().amax(dim=(1, 2, 3)) * dx["x1"].flatten())
    # a deck without a field (the TOV star) has div B exactly 0
    bmax = max(max(float(v.abs().max()) for v in bfc.values()), 1e-30)
    out = []
    for lev in sorted(set(int(v) for v in mesh.mb_lev)):
        sel = torch.as_tensor(mesh.mb_lev == lev, device=u.device)
        out.append(float(div[sel].max()) / bmax)
    if max(out) > 1e-5:
        raise AssertionError(f"{label}: max|div B| dx / max|B| by level "
                             f"{out} > 1e-5")
    return out


def smr_stage_parts(torch, phys, state, dt) -> dict:
    """ms per call of each piece of one general-path stage on a refined
    mesh, on the deck's own state."""
    from athenak_tpu_torch.physics import mhd_smr
    from athenak_tpu_torch.physics.mhd import compute_bcc
    from athenak_tpu_torch.refinement import flux_correct_cc
    w, bcc, bfc, u = state["w"], state["bcc"], state["bfc"], state["u"]
    mesh, act = phys.mesh, phys.bvals.active_axes
    names = [d[0] for d in phys.dirs]
    flx, emf = phys.fluxes(w, bcc, bfc)
    fden = {n: flx[n][:, 0] for n in flx}
    uc = u.clone()
    bc = {k: v.clone() for k, v in bfc.items()}

    def emf_ct():
        e = mhd_smr.emf_correct(mesh, act, *phys.corner_e(w, bcc, fden, emf))
        return phys.ct_update(bfc, bfc, *e, 0.5, 0.5, 0.5 * dt)

    return {"fused_flux_dir x3": cuda_ms(lambda: phys.fluxes(w, bcc, bfc),
                                         5),
            "flux_correct": cuda_ms(
                lambda: flux_correct_cc(flx, mesh, names), 5),
            "rk_update": cuda_ms(lambda: phys.rk_update(
                u, u, flx, 0.5, 0.5, 0.5 * dt), 5),
            "corner_e + emf_correct + ct": cuda_ms(emf_ct, 5),
            "fill_cc": cuda_ms(lambda: phys.bvals.fill_ghosts(uc), 5),
            "fill_fc": cuda_ms(lambda: phys.fill_ghosts_fc(bc), 5),
            "bcc + c2p": cuda_ms(lambda: phys.cons_to_prim(
                u, compute_bcc(bfc)), 5)}


def phase_smr_main(torch, kernels, card):
    """The SMR deck at 128^3 / 32^3 and the Orszag-Tang deck at 1024^2
    through the CLI for NCYC_SMR cycles, kernel path and plain path: the
    exact launches of kernel J (and of nothing else), div(B) by level,
    the volume-weighted mass, the paths against each other; timings."""
    from athenak_tpu_torch.main import build
    out = {}
    runs = (("smr", SMR_DECK, SMR_FULL, 3), ("ot", OT_DECK, OT_FULL, 2))
    for label, deck, extra, ndir in runs:
        extra = ["job/precision=single", *extra]
        mesh0, _, _, _, state0 = build(pin_for(extra, deck), device="cuda")
        mass0 = volume_mass(torch, mesh0, state0["u"])
        del state0
        states, launches = {}, {}
        for use in ("true", "false"):
            got, mesh, phys, driver, state, _, _ = run_cli(
                torch, kernels, deck, NCYC_SMR,
                extra + [f"mhd/use_kernels={use}"])
            n = mesh.ncycle
            expect = ndir * 2 * n if use == "true" else 0
            if got["fused_flux_dir"] != expect or \
                    sum(got.values()) != expect:
                raise AssertionError(f"{label} use_kernels={use}: launches "
                                     f"{got}, fused_flux_dir should be "
                                     f"{expect} and nothing else")
            divb = check_levels(torch, mesh, state, f"{label} {use}")
            dmass = abs(volume_mass(torch, mesh, state["u"]) - mass0) / mass0
            if dmass > 1e-5:
                raise AssertionError(f"{label} {use}: mass drift {dmass:g}")
            states[use], launches[use] = state, got
            if use == "true":
                kphys, kmesh = phys, mesh
            print(f"phase 13: {label} use_kernels={use}: {n} cycles on "
                  f"{mesh.nmb_total} blocks (levels "
                  f"{sorted(set(mesh.mb_lev.tolist()))}), launches {got}, "
                  f"max|div B| dx / max|B| by level {divb}, mass drift "
                  f"{dmass:.3e}, counters {driver.ecounters}; [{card}] CLI "
                  f"zone-cycles/s {driver.zcps:.6e} (wall clock, first cycle "
                  f"included)")
        k, p = states["true"], states["false"]
        diff = {}
        for key, a, b in [("u", k["u"], p["u"])] + [
                (c, k["bfc"][c], p["bfc"][c]) for c in k["bfc"]]:
            a, b = interior(a), interior(b)
            scale = max(float(b.abs().max()), 1e-30)
            rel = ((a - b).abs() / scale).double()
            diff[key] = (float((rel < SMR_PATH_TOL[0]).double().mean()),
                         float(rel.max()))
            if not (diff[key][0] > 0.95 and diff[key][1] < SMR_PATH_TOL[1]):
                raise AssertionError(f"{label}: kernel and plain path apart "
                                     f"in {key}: {diff[key]}")
        parts = smr_stage_parts(torch, kphys, k, kmesh.dt) \
            if label == "smr" else None
        del states, k, p, state, kphys
        rates = {}
        for use in ("true", "false", "true", "false"):
            rates.setdefault(use, []).append(
                timed_cycles(torch, use, deck, NCYC_TURNS, extra))
        mbi = mesh.mb_indcs
        zones = mesh.nmb_total * mbi.nx1 * mbi.nx2 * mbi.nx3
        cycle_ms = [zones / r * 1e3 for r in rates["true"]]
        print(f"phase 13: [{card}] {label} kernel vs plain path after "
              f"{NCYC_SMR} cycles (share within {SMR_PATH_TOL[0]}, max "
              f"scale-relative) {diff}; zone-cycles/s over {NCYC_TURNS} "
              f"cycles after a warm-up, kernel path {rates['true']}, plain "
              f"path {rates['false']} (CUDA events); kernel-path cycle "
              f"{cycle_ms} ms; one stage's parts, ms {parts}")
        out[label] = {"launches": launches["true"], "rates": rates,
                      "cycle_ms": cycle_ms, "parts": parts,
                      "path_diff": diff}
    return out


def hydro_parts(torch, phys, state, mesh) -> dict:
    """ms per call of each piece of a hydro cycle on the deck's own
    state: the forcing, the fluxes (reconstruction and Riemann solver
    of every direction), the RK update, the fill of u and the c2p."""
    u, w, dt = state["u"], state["w"], mesh.dt
    flx = phys.fluxes(w)
    uc = u.clone()
    parts = {"fluxes": cuda_ms(lambda: phys.fluxes(w), 5),
             "rk_update": cuda_ms(lambda: phys.rk_update(
                 u, u, flx, 0.5, 0.5, 0.5 * dt), 5),
             "fill_cc": cuda_ms(lambda: phys.bvals.fill_ghosts(uc), 20),
             "c2p": cuda_ms(lambda: phys.cons_to_prim(u), 5)}
    if phys.pturb is not None:
        parts["forcing"] = cuda_ms(
            lambda: phys.pturb.apply(state, dt, phys), 5)
    return parts


def phase_hydro_main(torch, kernels, card):
    """hturb1, hturb8 and hblast through the CLI in float32, kernel path
    and plain path (``hydro/use_kernels=false``), with the launch counts
    set to 0 before each run and checked exactly: the fill kernels only
    (B on hturb1, G on hturb8, once at initialisation and once a stage;
    nothing on hblast, whose three ghost cells no fill kernel takes).
    Finite state, mass to 1e-5, the net momentum after one more forcing
    below 1e-6 of |M|, the two paths bitwise equal; zone-cycles/s of
    each path in turns and the parts of a cycle."""
    out = {}
    runs = (("hturb1", HTURB_DECK, HTURB1, "periodic_fill_cc"),
            ("hturb8", HTURB_DECK, HTURB8, "pool_fill"),
            ("hblast", HBLAST_DECK, HBLAST, None))
    for label, deck, extra, fill_kernel in runs:
        states, launches = {}, {}
        for use in ("true", "false"):
            got, mesh, phys, driver, state, dmass, _ = run_cli(
                torch, kernels, deck, NCYC_HYDRO,
                extra + [f"hydro/use_kernels={use}"])
            n = mesh.ncycle
            expect = {fill_kernel: 2 * n + 1} \
                if use == "true" and fill_kernel else {}
            if {k: v for k, v in got.items() if v} != expect:
                raise AssertionError(f"{label} use_kernels={use}: launches "
                                     f"{got}, expected {expect}")
            if not all(bool(torch.isfinite(state[k]).all())
                       for k in ("u", "w")):
                raise AssertionError(f"{label} {use}: non-finite state")
            if dmass > 1e-5:
                raise AssertionError(f"{label} {use}: mass drift {dmass:g}")
            mom = check_forcing(torch, phys, state, mesh, label) \
                if phys.pturb is not None else None
            states[use], launches[use] = state, got
            if use == "true":
                kphys, kmesh = phys, mesh
            print(f"phase 14: {label} use_kernels={use}: {n} cycles on "
                  f"{mesh.nmb_total} block(s) of "
                  f"{mesh.mb_indcs.nx1}^3, launches "
                  f"{ {k: v for k, v in got.items() if v} }, mass drift "
                  f"{dmass:.3e}, net momentum after forcing {mom}, "
                  f"counters {driver.ecounters}; [{card}] CLI zone-cycles/s "
                  f"{driver.zcps:.6e} (wall clock, first cycle included)")
        k, p = states["true"], states["false"]
        for key in ("u", "w"):
            if not torch.equal(k[key], p[key]):
                raise AssertionError(f"{label}: kernel and plain path not "
                                     f"bitwise equal in {key}")
        parts = hydro_parts(torch, kphys, k, kmesh)
        del states, k, p, state, kphys
        rates = {}
        for use in ("true", "false", "true", "false"):
            rates.setdefault(use, []).append(timed_cycles(
                torch, use, deck, NCYC_TURNS, extra, block="hydro"))
        mbi = mesh.mb_indcs
        zones = mesh.nmb_total * mbi.nx1 * mbi.nx2 * mbi.nx3
        cycle_ms = [zones / r * 1e3 for r in rates["true"]]
        print(f"phase 14: [{card}] {label} kernel and plain path bitwise "
              f"equal after {NCYC_HYDRO} cycles; zone-cycles/s over "
              f"{NCYC_TURNS} cycles after a warm-up, kernel path "
              f"{rates['true']}, plain path {rates['false']} (CUDA "
              f"events); kernel-path cycle {cycle_ms} ms; ms per call on "
              f"the deck's state {parts}")
        out[label] = {"launches": launches["true"], "rates": rates,
                      "parts": parts, "cycle_ms": cycle_ms}
    return out


def div_b(torch, phys, bfc, ng=2):
    """max|div B| dx / max(max|B|, 1e-30) over the interior (``ng``
    cells off every side), and the div B array itself, of a face field
    of a 1-D, 2-D or 3-D block."""
    b1, b2, b3 = bfc["x1f"], bfc["x2f"], bfc["x3f"]
    div = (b1[..., 1:] - b1[..., :-1]) / phys.dxs["x1"]
    if len(phys.dirs) > 1:
        div = div + (b2[..., 1:, :] - b2[..., :-1, :]) / phys.dxs["x2"]
    if len(phys.dirs) > 2:
        div = div + (b3[:, 1:] - b3[:, :-1]) / phys.dxs["x3"]
    bmax = max(max(float(v.abs().max()) for v in bfc.values()), 1e-30)
    div = interior(div, ng)
    return float(div.abs().max()) * phys.dxs["x1"] / bmax, div, bmax


def change_diff(got, ref, init):
    """(share of interior cells within SMR_PATH_TOL[0], max) of
    |got - ref| over the reference's max|ref - init|: how far two runs
    from the same ``init`` are apart, on the scale of what they
    changed."""
    got, ref, init = interior(got), interior(ref), interior(init)
    scale = max(float((ref - init).abs().max()), 1e-30)
    rel = ((got - ref).abs() / scale).double()
    return (float((rel < SMR_PATH_TOL[0]).double().mean()),
            float(rel.max()))


def tail_flux_check(torch, card):
    """Kernel J against its plain version on the 1-D bw row with the
    Brio-Wu field (x1, as initialised and after 5 cycles): float32
    two-tier, float64 1e-10, and its time on the initial state."""
    from athenak_tpu_torch.ops import flux
    maxerr, res = 0.0, None
    for ncyc in (0, 5):
        for prec in ("single", "double"):
            state, phys = deck_state(torch, TAIL_DECKS["bw"], BW_FIELD, prec,
                                     ncyc)
            w, bcc, bfc = state["w"], state["bcc"], state["bfc"]
            args = (w, bcc, bfc["x1f"], phys.eos, "x1", 1)
            got = flux.fused_flux_dir(*args)
            ref = flux.flux_dir_plain(*args)
            torch.cuda.synchronize()
            if not float(faces(ref[1]).abs().max()) > 0.0:
                raise AssertionError("bw: the plain ey is zero; the field "
                                     "did not reach the row")
            pairs = [(got[0][:, c], ref[0][:, c], f"flux {c}")
                     for c in range(5)]
            pairs += [(got[1], ref[1], "ey"), (got[2], ref[2], "ez")]
            for g, r, what in pairs:
                g, r = faces(g), faces(r)
                scale = float(r.abs().max()) or 1.0
                tag = f"bw {ncyc} cycles {prec} {what}"
                if prec == "single":
                    maxerr = max(maxerr, two_tier(g, r, scale, tag))
                elif float((g - r).abs().max()) / scale > 1e-10:
                    raise AssertionError(f"{tag}: "
                                         f"{float((g - r).abs().max())}")
            if prec == "single" and ncyc == 0:
                cells = w[:, 0].numel()
                res = {"ms": cuda_ms(lambda: flux.fused_flux_dir(*args), 50),
                       "plain_ms": cuda_ms(lambda: flux.flux_dir_plain(
                           *args), 20),
                       "bound": bound(15 * cells * w.element_size(),
                                      OPS_FACE["hlld"] * cells),
                       "cells": cells}
    print(f"phase 15: fused_flux_dir agrees with its plain version on the "
          f"1-D bw row with the Brio-Wu field (x1; as initialised and after "
          f"5 cycles; f32 two-tier, f64 1e-10); [{card}] {res['ms']:.4f} ms "
          f"a call on {res['cells']} cells (plain {res['plain_ms']:.4f} ms, "
          f"bound {res['bound'][0]:.6f} by {res['bound'][1]})")
    res["max_abs_err"] = maxerr
    return res


def tail_stage_check(torch, card):
    """Kernel A against its plain version on both RK2 stages of the
    field_loop3d and linear_wave_mhd states (64 x 32 x 32, 68 x 36 x 36
    with ghosts) in float64, on the scale of what the stage changed:
    the linear wave moves 1e-6 of its background, below what float32
    resolves, so only float64 holds A to the wave itself."""
    from athenak_tpu_torch.ops import stage
    out = {}
    for label in ("field_loop3d", "linear_wave_mhd"):
        state, phys = deck_state(torch, TAIL_DECKS[label], [], "double")
        u0, b0, dt = state["u"], state["bfc"], phys.mesh.dt
        inp_u, inp_b = u0, b0
        for s, (g0, g1, beta) in enumerate(((0.0, 1.0, 1.0),
                                            (0.5, 0.5, 0.5))):
            args = (inp_u, inp_b, u0, b0, phys.eos, g0, g1, beta * dt,
                    phys.dxs)
            uk, bk, _ = stage.mega_stage_v2(*args)
            up, bp, _ = stage.mega_stage_v2_plain(*args)
            torch.cuda.synchronize()
            diff = {"u": change_diff(uk, up, inp_u)}
            bscale = max(float((interior(bp[c]) - interior(inp_b[c]))
                               .abs().max()) for c in bp)
            for c in bp:
                err = (interior(bk[c]) - interior(bp[c])).abs().max()
                diff[c] = (None, float(err) / max(bscale, 1e-30))
            worst = max(v[1] for v in diff.values())
            tag = f"{label} stage {s + 1}"
            if not worst <= TAIL_STAGE_TOL:
                raise AssertionError(f"{tag}: kernel A and its plain version "
                                     f"apart by {diff} of the change")
            out[tag] = worst
            inp_u, inp_b = fill_plain(phys, up, bp)
        del state, u0, b0, inp_u, inp_b, uk, bk, up, bp
    print(f"phase 15: mega_stage_v2 agrees with its plain version on "
          f"field_loop3d and linear_wave_mhd (64 x 32 x 32, both RK2 "
          f"stages, f64), max |difference| over the stage's max|change| "
          f"{out} (limit {TAIL_STAGE_TOL})")
    return out


def phase_tail_main(torch, kernels, card):
    """The Newtonian MHD test decks through the CLI in float32 at their
    shipped sizes, kernel path and plain path, NCYC_TAIL cycles, exact
    launch counts: J once a direction a stage on bw, kh2d-mhd and
    current_sheet; A twice a cycle and B on field_loop3d and
    linear_wave_mhd; on linear_wave_mhd with LLF, the isothermal gas or
    a passive scalar only B.  Finite state, div B kept where the initial
    field put it (at round-off but for the current sheet, whose initial
    field is not discretely solenoidal), mass to 1e-5, the two paths
    within SMR_PATH_TOL's tiers of what the plain path changed (each
    field's change from the initial state); zone-cycles/s of each
    path."""
    flux_res = tail_flux_check(torch, card)
    flux_res["stage_check"] = tail_stage_check(torch, card)
    out = {}
    runs = [(name, deck, []) for name, deck in TAIL_DECKS.items()]
    runs += [(f"linear_wave_mhd {tag}", TAIL_DECKS["linear_wave_mhd"], [ov])
             for tag, ov in (("llf", "mhd/rsolver=llf"),
                             ("isothermal", "mhd/eos=isothermal"),
                             ("scalar", "mhd/nscalars=1"))]
    from athenak_tpu_torch.main import build
    for label, deck, extra in runs:
        extra = ["job/precision=single", *extra]
        _, phys0, _, _, state0 = build(pin_for(extra, deck), device="cuda")
        div0 = div_b(torch, phys0, state0["bfc"])[1]
        init = {"u": state0["u"], **state0["bfc"]}
        del state0, phys0
        states, launches = {}, {}
        for use in ("true", "false"):
            # the wave tests write their error files in the run directory
            got, mesh, phys, driver, state, dmass, _ = run_cli(
                torch, kernels, deck, NCYC_TAIL,
                extra + [f"mhd/use_kernels={use}"])
            n = mesh.ncycle
            ndir = len(phys.dirs)
            if use == "false":
                expect = {}
            elif label in ("field_loop3d", "linear_wave_mhd"):
                expect = {"mega_stage_v2": 2 * n,
                          "periodic_fill_cc": 2 * n + 3,
                          "periodic_fill_fc": 2 * n + 3}
            elif ndir == 3:
                expect = {"periodic_fill_cc": 2 * n + 1,
                          "periodic_fill_fc": 2 * n + 1}
            else:
                expect = {"fused_flux_dir": 2 * ndir * n}
            got = {k: v for k, v in got.items() if v}
            if got != expect:
                raise AssertionError(f"{label} use_kernels={use}: launches "
                                     f"{got}, expected {expect}")
            if not all(bool(torch.isfinite(v).all()) for v in
                       [state["u"], *state["bfc"].values()]):
                raise AssertionError(f"{label} {use}: non-finite state")
            divb, div, bmax = div_b(torch, phys, state["bfc"])
            ddiv = float((div - div0).abs().max()) * phys.dxs["x1"] / bmax
            if ddiv > 1e-5 or (label != "current_sheet" and divb > 1e-5):
                raise AssertionError(f"{label} {use}: div B {divb:g}, "
                                     f"changed by {ddiv:g}")
            if dmass > 1e-5:
                raise AssertionError(f"{label} {use}: mass drift {dmass:g}")
            states[use], launches[use] = state, got
            print(f"phase 15: {label} use_kernels={use}: {n} cycles, "
                  f"launches {got}, max|div B| dx / max|B| {divb:.3e} "
                  f"(change {ddiv:.3e}), mass drift {dmass:.3e}, counters "
                  f"{driver.ecounters}; [{card}] CLI zone-cycles/s "
                  f"{driver.zcps:.6e} (wall clock, first cycle included)")
        k, p = states["true"], states["false"]
        diff = {}
        for key, a, b in [("u", k["u"], p["u"])] + [
                (c, k["bfc"][c], p["bfc"][c]) for c in k["bfc"]]:
            diff[key] = change_diff(a, b, init[key])
            if not (diff[key][0] > 0.95 and diff[key][1] < SMR_PATH_TOL[1]):
                raise AssertionError(f"{label}: kernel and plain path apart "
                                     f"in {key}: {diff[key]}")
        del states, k, p, state, init
        rates = {use: [timed_cycles(torch, use, deck, NCYC_TAIL, extra)]
                 for use in ("true", "false")}
        print(f"phase 15: [{card}] {label} kernel vs plain path after "
              f"{NCYC_TAIL} cycles (share within {SMR_PATH_TOL[0]}, max; "
              f"of the plain path's max|change|) {diff}; zone-cycles/s over "
              f"{NCYC_TAIL} "
              f"cycles after a warm-up, kernel path {rates['true']}, plain "
              f"path {rates['false']} (CUDA events)")
        out[label] = {"launches": launches["true"], "rates": rates,
                      "path_diff": diff}
    return out, flux_res


def host_ms(torch, fn, reps: int = 3) -> float:
    """Mean milliseconds per call of fn() on the host clock, the card
    synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def output_ms(torch, kind, pin, mesh, phys, state, block="output9"):
    """Host ms of one write of an output of ``kind`` (hst, rst or vtk)
    of ``state``, into a temporary directory."""
    from athenak_tpu_torch import outputs
    pin.set_value(block, "file_type", kind)
    if kind == "vtk":
        pin.set_value(block, "variable", "hydro_w")
    out, = [o for o in outputs.make_outputs(pin, mesh, phys)
            if getattr(o, "params", None) and o.params.block == block]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            return host_ms(torch, lambda: out.write(mesh, state))
        finally:
            os.chdir(cwd)


def slice_turb(torch, kernels, card):
    """inputs/turb/turb.athinput as shipped (60^3, float32) and at 128^3
    through the CLI, kernel path and plain path: B on u at
    initialisation and once a stage exactly, nothing on the plain path,
    the two paths (state and history file) bitwise equal, nfofc
    counted; zone-cycles/s of each path in turns; the host ms of the
    FOFC step, one hst row and one rst file on the 60^3 state."""
    out, parts = {}, {}
    for label, extra in (("turb60", []), ("turb128", TURB128)):
        states, launches, hst = {}, {}, {}
        for use in ("true", "false"):
            got, mesh, phys, driver, state, dmass, written = run_cli(
                torch, kernels, TURB60_DECK, NCYC_SLICE,
                extra + [f"hydro/use_kernels={use}"])
            n = mesh.ncycle
            expect = {"periodic_fill_cc": 2 * n + 1} if use == "true" else {}
            got = {k: v for k, v in got.items() if v}
            if got != expect:
                raise AssertionError(f"{label} use_kernels={use}: launches "
                                     f"{got}, expected {expect}")
            if not (phys.use_fofc and "nfofc" in driver.ecounters):
                raise AssertionError(f"{label}: FOFC did not run")
            if not all(bool(torch.isfinite(state[k]).all())
                       for k in ("u", "w")) or dmass > 1e-5:
                raise AssertionError(f"{label} {use}: non-finite state or "
                                     f"mass drift {dmass:g}")
            hst[use] = written.get("Turb.hst")
            if not hst[use] or len(hst[use].splitlines()) < 4:
                raise AssertionError(f"{label} {use}: no history rows")
            mom = check_forcing(torch, phys, state, mesh, label)
            states[use], launches[use] = state, got
            print(f"phase 16: {label} use_kernels={use}: {n} cycles, "
                  f"launches {got}, counters {driver.ecounters} (nfofc "
                  f"{driver.ecounters['nfofc']}), mass drift {dmass:.3e}, "
                  f"net momentum after forcing {mom:.3e}, history rows "
                  f"{len(hst[use].splitlines()) - 2}; [{card}] CLI "
                  f"zone-cycles/s {driver.zcps:.6e} (wall clock)")
            if use == "true" and label == "turb60":
                saved = phys.save_state(state)
                flx = phys.fluxes(state["w"])
                parts = {
                    "fofc_ms": cuda_ms(lambda: phys._apply_fofc(
                        state["u"], saved["u1"], state["w"], flx, 0.5, 0.5,
                        0.5 * mesh.dt), 5),
                    "stage_ms": cuda_ms(lambda: phys.stage_update(
                        state, saved, 0.5, 0.5, 0.5 * mesh.dt), 5),
                    "hst_ms": output_ms(torch, "hst", pin_for(
                        extra, TURB60_DECK), mesh, phys, state),
                    "rst_ms": output_ms(torch, "rst", pin_for(
                        extra, TURB60_DECK), mesh, phys, state)}
        k, p = states["true"], states["false"]
        for key in ("u", "w"):
            if not torch.equal(k[key], p[key]):
                raise AssertionError(f"{label}: kernel and plain path not "
                                     f"bitwise equal in {key}")
        if hst["true"] != hst["false"]:
            raise AssertionError(f"{label}: the paths' history files differ")
        del states, k, p, state
        rates = {}
        for use in ("true", "false", "true", "false"):
            rates.setdefault(use, []).append(timed_cycles(
                torch, use, TURB60_DECK, NCYC_SLICE, extra, block="hydro"))
        print(f"phase 16: [{card}] {label} kernel and plain path bitwise "
              f"equal (state and hst) after {NCYC_SLICE} cycles; "
              f"zone-cycles/s kernel path {rates['true']}, plain path "
              f"{rates['false']} (CUDA events)")
        out[label] = {"launches": launches["true"], "rates": rates}
    print(f"phase 16: [{card}] turb60 host ms a call: FOFC step "
          f"{parts['fofc_ms']:.3f} within a stage of "
          f"{parts['stage_ms']:.3f}, one hst row {parts['hst_ms']:.3f}, "
          f"one rst file {parts['rst_ms']:.3f}")
    return out, parts


def poked_run(torch, kernels, use, deck=DECK, block="mhd",
              pokes=FOFC_POKES, extra=()):
    """A deck with ``<block>/fofc=true`` (the 124^3 blast unless given),
    the total energy of the ``pokes`` cells scaled by 1e-12 after
    initialisation with the primitives left as initialised (the first
    stage's trial update of those cells then falls below their kinetic
    or magnetic energy, and the energy floor fires), run NCYC_SLICE
    cycles with the launch counts set to 0 just before; returns
    (launches, the poked state, the final state, driver, phys)."""
    from athenak_tpu_torch.main import build
    mesh, phys, _, driver, state = build(pin_for(
        [f"{block}/fofc=true", f"{block}/use_kernels={use}", f"time/nlim="
         f"{NCYC_SLICE}", *extra], deck), device="cuda")
    state = driver.initialize(state)
    u = state["u"].clone()
    for k, j, i in pokes:
        u[0, 4, k, j, i] *= 1e-12
    state = dict(state, u=u)
    init = {"u": u, **{c: v.clone() for c, v in state.get("bfc",
                                                           {}).items()}}
    kernels.reset_counts()
    state = driver.execute(state)
    launches = {k.name: k.launches for k in kernels.ALL if k.launches}
    return launches, init, state, driver, phys


def poked_turb(torch, kernels, card):
    """turb60 with TURB_POKES poked, kernel path and plain path: B once
    a stage exactly, nfofc > 0 on both, the two paths bitwise equal in
    u and w; returns (launches, nfofc) of the kernel path."""
    states, res = {}, {}
    for use in ("true", "false"):
        got, _, state, driver, _ = poked_run(
            torch, kernels, use, TURB60_DECK, "hydro", TURB_POKES)
        n = driver.mesh.ncycle
        expect = {"periodic_fill_cc": 2 * n} if use == "true" else {}
        if got != expect:
            raise AssertionError(f"poked turb60 use_kernels={use}: launches "
                                 f"{got}, expected {expect}")
        nfofc = driver.ecounters.get("nfofc", 0)
        if not nfofc > 0 or not bool(torch.isfinite(state["u"]).all()):
            raise AssertionError(f"poked turb60 {use}: nfofc {nfofc}, or a "
                                 "non-finite state")
        states[use], res[use] = state, (got, nfofc)
        print(f"phase 16: poked turb60 use_kernels={use}: {n} cycles, "
              f"launches {got}, counters {driver.ecounters}")
    for key in ("u", "w"):
        if not torch.equal(states["true"][key], states["false"][key]):
            raise AssertionError(f"poked turb60: kernel and plain path not "
                                 f"bitwise equal in {key}")
    if res["true"][1] != res["false"][1]:
        raise AssertionError(f"poked turb60: nfofc {res['true'][1]} on the "
                             f"kernel path, {res['false'][1]} on the plain")
    print(f"phase 16: [{card}] poked turb60: nfofc {res['true'][1]}, kernel "
          f"and plain path bitwise equal in u and w")
    return res["true"]


def slice_fofc_blast(torch, kernels, card):
    """The poked FOFC blast, kernel path and plain path: J three times a
    stage, D once, A never (the FOFC gate), B on u and the faces once a
    stage, exact; nfofc > 0; finite, div B at round-off, the paths
    within SMR_PATH_TOL's tiers of what the plain path changed;
    zone-cycles/s against the same deck without FOFC (kernel A), in
    turns; the host ms of the FOFC step of a stage."""
    states, res = {}, {}
    for use in ("true", "false"):
        got, init, state, driver, phys = poked_run(torch, kernels, use)
        n = driver.mesh.ncycle
        expect = {"fused_flux_dir": 6 * n, "fused_ct3d": 2 * n,
                  "periodic_fill_cc": 2 * n, "periodic_fill_fc": 2 * n} \
            if use == "true" else {}
        if got != expect:
            raise AssertionError(f"fofc blast use_kernels={use}: launches "
                                 f"{got}, expected {expect}")
        if not driver.ecounters.get("nfofc", 0) > 0:
            raise AssertionError(f"fofc blast {use}: FOFC never fired")
        divb = check_state(torch, phys, state, 0.0, f"fofc blast {use}")
        states[use] = state
        res[use] = {"launches": got, "nfofc": driver.ecounters["nfofc"],
                    "counters": dict(driver.ecounters),
                    "zcps_wall": driver.zcps}
        print(f"phase 16: fofc blast use_kernels={use}: {n} cycles, "
              f"launches {got}, counters {driver.ecounters}, div(B) "
              f"{divb:.3e}; [{card}] zone-cycles/s {driver.zcps:.6e} "
              f"(wall clock)")
        if use == "true":
            saved = phys.save_state(state)
            flx, emf = phys.fluxes(state["w"], state["bcc"], state["bfc"])
            res["fofc_ms"] = cuda_ms(lambda: phys._apply_fofc(
                state["u"], saved["u1"], state["w"], state["bcc"],
                state["bfc"], flx, emf, 0.5, 0.5, 0.5 * driver.mesh.dt), 5)
    k, p = states["true"], states["false"]
    diff = {}
    for key, a, b in [("u", k["u"], p["u"])] + [
            (c, k["bfc"][c], p["bfc"][c]) for c in k["bfc"]]:
        diff[key] = change_diff(a, b, init[key])
        if not (diff[key][0] > 0.95 and diff[key][1] < SMR_PATH_TOL[1]):
            raise AssertionError(f"fofc blast: kernel and plain path apart "
                                 f"in {key}: {diff[key]}")
    del states, k, p, state, init
    rates = {}
    for label, extra in (("fofc", ["mhd/fofc=true"]), ("no fofc", []),
                         ("fofc", ["mhd/fofc=true"]), ("no fofc", [])):
        rates.setdefault(label, []).append(
            timed_cycles(torch, "true", DECK, NCYC_SLICE, extra))
    print(f"phase 16: [{card}] fofc blast kernel vs plain path (share "
          f"within {SMR_PATH_TOL[0]}, max; of the plain path's max|change|) "
          f"{diff}; zone-cycles/s with FOFC (J + D) {rates['fofc']}, "
          f"without (A) {rates['no fofc']} (CUDA events); FOFC step "
          f"{res['fofc_ms']:.3f} ms")
    res.update(path_diff=diff, rates=rates)
    return res


def slice_restart(torch, kernels, card):
    """Restart through -r on the card: the blast (kernel A) and the
    turbulence deck (B, forcing, FOFC), 2 x NCYC_SLICE cycles straight
    and as NCYC_SLICE cycles, a .rst, then -r and NCYC_SLICE more: u
    (and under MHD the face field) bitwise equal, the history rows after
    the restart point equal."""
    from athenak_tpu_torch import main as cli_main
    from athenak_tpu_torch.outputs import load_restart
    n = NCYC_SLICE
    out = {}
    os.environ["ATHENAK_DEVICE"] = "cuda"
    # a history row every cycle, printed to the last bit of the time
    rows = ["output1/dcycle=1", "output1/data_format=%.17e"]
    runs = (("blast", DECK, "Blast", ["output1/file_type=hst", *rows]),
            ("turb60", TURB60_DECK, "Turb", rows))
    cwd = os.getcwd()
    for label, deck, base, extra in runs:
        common = [*extra, "output9/file_type=rst", f"output9/dcycle={n}"]
        with tempfile.TemporaryDirectory() as tmp:
            try:
                kernels.reset_counts()
                *_, s1 = cli_main.cli([
                    "-i", deck, "-d", os.path.join(tmp, "straight"),
                    *common, f"time/nlim={2 * n}"])
                straight_launches = {k.name: k.launches
                                     for k in kernels.ALL if k.launches}
                os.chdir(cwd)
                cli_main.cli(["-i", deck, "-d", os.path.join(tmp, "first"),
                              *common, f"time/nlim={n}"])
                os.chdir(cwd)
                rst = os.path.join(tmp, "first", f"{base}.00001.rst")
                t_rst = load_restart(rst)[1]
                kernels.reset_counts()
                mesh, phys, _, s2 = cli_main.cli([
                    "-r", rst, "-d", os.path.join(tmp, "first"),
                    f"time/nlim={2 * n}"])
                resumed_launches = {k.name: k.launches
                                    for k in kernels.ALL if k.launches}
            finally:
                os.chdir(cwd)
            rows = []
            for run in ("straight", "first"):
                with open(os.path.join(tmp, run, f"{base}.hst")) as f:
                    rows.append([r for r in f.read().splitlines()[2:]
                                 if float(r.split()[0]) > t_rst])
        keys = ["u"] + ([f"bfc/{c}" for c in s1["bfc"]] if "bfc" in s1
                        else [])
        for key in keys:
            a = s1[key] if "/" not in key else s1["bfc"][key[4:]]
            b = s2[key] if "/" not in key else s2["bfc"][key[4:]]
            if not torch.equal(a, b):
                raise AssertionError(f"restart {label}: {key} not bitwise "
                                     "equal to the straight run")
        if mesh.ncycle != 2 * n or not rows[0] or rows[0] != rows[1]:
            raise AssertionError(f"restart {label}: {mesh.ncycle} cycles; "
                                 f"history rows after the restart differ: "
                                 f"{rows}")
        out[label] = {"straight": straight_launches,
                      "resumed": resumed_launches, "rows": len(rows[0])}
        print(f"phase 16: restart {label}: {2 * n} cycles straight and "
              f"{n} + -r {n} bitwise equal in {keys}; {len(rows[0])} "
              f"history rows after t = {t_rst:.6e} equal; launches "
              f"straight {straight_launches}, resumed {resumed_launches}")
    return out


def rt2d_flux_check(torch, card):
    """Kernel J against its plain version on rt2d-mhd (64 x 192, 68 x 196
    with ghosts; reflecting x2 walls, constant gravity), as initialised
    and after 5 cycles, in both directions: float32 two-tier of each
    channel's scale (RT_FLUX_FLOOR), float64 within 1e-10 of it; f32
    times of the initial state."""
    from athenak_tpu_torch.ops import flux
    maxerr, res = 0.0, {}
    for ncyc in (0, 5):
        for prec in ("single", "double"):
            state, phys = deck_state(torch, SLICE_DECKS["rt2d-mhd"], [],
                                     prec, ncyc)
            w, bcc, bfc = state["w"], state["bcc"], state["bfc"]
            for name, _axis, ivx, _dx in phys.dirs:
                args = (w, bcc, bfc[f"{name}f"], phys.eos, name, ivx)
                got = flux.fused_flux_dir(*args)
                ref = flux.flux_dir_plain(*args)
                torch.cuda.synchronize()
                pairs = [(got[0][:, c], ref[0][:, c], f"flux {c}")
                         for c in range(5)]
                pairs += [(got[1], ref[1], "ey"), (got[2], ref[2], "ez")]
                top = max(float(faces(r).abs().max()) for _, r, _ in pairs)
                for g, r, what in pairs:
                    g, r = faces(g), faces(r)
                    scale = max(float(r.abs().max()), RT_FLUX_FLOOR * top)
                    tag = f"rt2d-mhd {ncyc} cycles {prec} {name} {what}"
                    if prec == "single":
                        maxerr = max(maxerr, two_tier(g, r, scale, tag))
                    elif float((g - r).abs().max()) / scale > 1e-10:
                        raise AssertionError(
                            f"{tag}: {float((g - r).abs().max())}")
                if prec == "single" and ncyc == 0:
                    cells = w[:, 0].numel()
                    res[name] = {
                        "ms": cuda_ms(lambda: flux.fused_flux_dir(*args), 50),
                        "plain_ms": cuda_ms(
                            lambda: flux.flux_dir_plain(*args), 20),
                        "bound": bound(15 * cells * w.element_size(),
                                       OPS_FACE["hlld"] * cells)}
            del state, w, bcc, bfc, got, ref
    print(f"phase 16: fused_flux_dir agrees with its plain version on "
          f"rt2d-mhd (68 x 196 with ghosts; x1 and x2, as initialised and "
          f"after 5 cycles; f32 two-tier, f64 1e-10); [{card}] " + "; ".join(
              f"{d} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
              f"{r['bound'][0]:.6f} by {r['bound'][1]})"
              for d, r in res.items()))
    return {"max_abs_err": maxerr, "by_dir": res}


def slice_decks(torch, kernels, card):
    """The SR hydro and source-term decks at their shipped sizes through
    the CLI for NCYC_SLICE cycles, rt2d-mhd also in float32 on the kernel
    path and the plain path: finite state, no c2p failure, exact
    launches (J twice a stage on rt2d-mhd in float32, nothing
    elsewhere), rt2d-mhd's two float32 paths within SMR_PATH_TOL's tiers
    of what the plain path changed; wall-clock zone-cycles/s; the host
    ms of the source terms (rt2d) and of one vtk dump (lw_implode)."""
    from athenak_tpu_torch.main import build
    out, parts, f32 = {}, {}, {}
    runs = [(name, deck, []) for name, deck in SLICE_DECKS.items()]
    runs += [(f"rt2d-mhd f32 {tag}", SLICE_DECKS["rt2d-mhd"],
              ["job/precision=single", f"mhd/use_kernels={use}"])
             for tag, use in (("kernel", "true"), ("plain", "false"))]
    for label, deck, extra in runs:
        got, mesh, phys, driver, state, dmass, written = run_cli(
            torch, kernels, deck, NCYC_SLICE, extra)
        n = mesh.ncycle
        expect = {"fused_flux_dir": 4 * n} \
            if label == "rt2d-mhd f32 kernel" else {}
        got = {k: v for k, v in got.items() if v}
        if got != expect:
            raise AssertionError(f"{label}: launches {got}, expected "
                                 f"{expect}")
        if not bool(torch.isfinite(state["u"]).all()) or \
                driver.ecounters.get("nc2p_fail", 0):
            raise AssertionError(f"{label}: non-finite state or c2p "
                                 f"failures {driver.ecounters}")
        mbi = mesh.mb_indcs
        out[label] = {"launches": got, "zcps": driver.zcps,
                      "cells": mesh.nmb_total * mbi.nx1 * mbi.nx2 * mbi.nx3,
                      "files": sorted(written)}
        print(f"phase 16: {label} ({mbi.nx1}x{mbi.nx2}x{mbi.nx3}, "
              f"{state['u'].dtype}): {n} cycles, launches {got}, counters "
              f"{driver.ecounters}, mass drift {dmass:.3e}, files "
              f"{sorted(written)}; [{card}] CLI zone-cycles/s "
              f"{driver.zcps:.6e} (wall clock, first cycle included)")
        if label.startswith("rt2d-mhd f32"):
            f32[label] = state
        if label == "rt2d":
            w = state["w"]
            parts["srcterms_ms"] = cuda_ms(lambda: phys.srcterms.apply(
                state["u"], w, 0.5 * mesh.dt), 20)
        if label == "lw_implode":
            parts["vtk_ms"] = output_ms(torch, "vtk", pin_for(
                extra, deck), mesh, phys, state)
    state0 = build(pin_for(["job/precision=single"],
                           SLICE_DECKS["rt2d-mhd"]), device="cuda")[-1]
    k, p = f32["rt2d-mhd f32 kernel"], f32["rt2d-mhd f32 plain"]
    diff = {}
    for key, a, b, a0 in [("u", k["u"], p["u"], state0["u"])] + [
            (c, k["bfc"][c], p["bfc"][c], state0["bfc"][c])
            for c in ("x1f", "x2f")]:
        diff[key] = change_diff(a, b, a0)
        if not (diff[key][0] > 0.95 and diff[key][1] < SMR_PATH_TOL[1]):
            raise AssertionError(f"rt2d-mhd f32: kernel and plain path apart "
                                 f"in {key}: {diff[key]}")
    parts["rt2d_mhd_path_diff"] = diff
    print(f"phase 16: [{card}] rt2d-mhd f32 kernel vs plain path after "
          f"{NCYC_SLICE} cycles (share within {SMR_PATH_TOL[0]}, max; of the "
          f"plain path's max|change|) {diff}")
    print(f"phase 16: [{card}] host ms a call: rt2d source terms "
          f"{parts['srcterms_ms']:.4f}, lw_implode vtk dump "
          f"{parts['vtk_ms']:.3f}")
    return out, parts


def phase_slice(torch, kernels, card):
    """Phase 16: this slice's decks (see the module docstring); its
    restarts run in a lane."""
    turb, turb_parts = slice_turb(torch, kernels, card)
    poked, nfofc = poked_turb(torch, kernels, card)
    fofc = slice_fofc_blast(torch, kernels, card)
    rt_flux = rt2d_flux_check(torch, card)
    decks, deck_parts = slice_decks(torch, kernels, card)
    launches = {**{k: v["launches"] for k, v in turb.items()},
                "poked turb60": poked,
                "fofc_blast": fofc["true"]["launches"],
                **{k: v["launches"] for k, v in decks.items()}}
    return {"launches": launches,
            "turb_rates": {k: v["rates"] for k, v in turb.items()},
            "fofc": {k: fofc[k] for k in ("true", "false", "rates",
                                          "path_diff", "fofc_ms")},
            "turb60_poked_nfofc": nfofc,
            "flux_dir_rt2d_mhd": rt_flux,
            "deck_zcps": {k: v["zcps"] for k, v in decks.items()},
            "parts_ms": {**turb_parts, "fofc_blast_ms": fofc["fofc_ms"],
                         **deck_parts}}


def range_diff(got, ref):
    """(share of interior cells within SMR_PATH_TOL[0], max) of
    |got - ref| over the range of ``ref`` (max - min over the interior):
    how far two runs are apart, on the scale of what varies in them.  An
    adaptive run ends on another tree than it starts, so what the plain
    path changed (``change_diff``) cannot be formed cell by cell; its
    blast starts from uniform ambient values, so the range is that
    change."""
    got, ref = interior(got), interior(ref)
    scale = max(float(ref.max() - ref.min()), 1e-30)
    rel = ((got - ref).abs() / scale).double()
    return (float((rel < SMR_PATH_TOL[0]).double().mean()),
            float(rel.max()))


def flat_cycles(trees, n):
    """The cycles of an n-cycle adaptive run taken on a flat tree: the run
    starts on the flat root tree, and the tree of the update at cycle c
    takes cycles c + 1 onward."""
    count, start, flat = 0, 0, True
    for c, leaves in trees:
        count += c - start if flat else 0
        start, flat = c, all(leaf[3] == 0 for leaf in leaves)
    return count + (n - start if flat else 0)


def amr_cli(torch, kernels, deck, ncyc, extra):
    """``run_cli`` with div(B) by level checked after every tree update
    (``check_levels``, which fails above 1e-5).  The trees (cycle,
    leaves), their times and each update's host ms are the AMR step's own
    record (``AMR.updates``); the cycles on a flat tree follow from it."""
    from athenak_tpu_torch import amr
    divb = []
    rebuild = amr.AMR.rebuild

    def checked(self, driver, state, new_leaves, prov, outputs=()):
        state = rebuild(self, driver, state, new_leaves, prov, outputs)
        if "bfc" in state:
            divb.append(check_levels(
                torch, driver.mesh, state, f"after the tree update of "
                f"cycle {driver.mesh.ncycle}"))
        return state

    amr.AMR.rebuild = checked
    try:
        launches, mesh, phys, driver, state, _, written = run_cli(
            torch, kernels, deck, ncyc, extra)
    finally:
        amr.AMR.rebuild = rebuild
    updates = driver.pamr.updates
    rec = {"trees": [(r["ncycle"], r["leaves"]) for r in updates],
           "times": [r["time"] for r in updates], "divb": divb,
           "timings": [{k: v for k, v in r.items() if k != "leaves"}
                       for r in updates],
           "hst": [t for f, t in written.items() if f.endswith(".hst")],
           "txt": {f: t for f, t in written.items() if f.endswith(".txt")}}
    rec["flat_cycles"] = flat_cycles(rec["trees"], ncyc)
    return launches, mesh, phys, driver, state, rec


def hst_times(text):
    """The time column of a history file's rows."""
    return [float(line.split()[0]) for line in text.splitlines()
            if line.strip() and not line.startswith("#")]


def pool_fill_expect(rec, n):
    """Kernel G's launches on block_pool=false while the tree is flat,
    for a run that refines once and stays refined: the face field and u
    (two launches) at every stage's fill, 4 a cycle, and at every fill
    that makes the primitives on the flat tree: the initial fill, the
    first dt (kernel A's state carries no primitives), the history write
    at t = 0 and each one before the first update (whose write comes
    after the new tree is in place), and the final write if the run
    ends flat."""
    flat = rec["flat_cycles"]
    if not rec["trees"]:
        return 4 * n + 2 * (2 + len(hst_times(rec["hst"][0])))
    if any(all(leaf[3] == 0 for leaf in t) for _, t in rec["trees"]):
        raise AssertionError("the tree flattened again: G's count has no "
                             "formula here")
    # a row carries its time to data_format's digits; the rows apart
    # by a cycle's dt, more than 1e-4 of the time within these runs
    t_first = rec["times"][0] * (1.0 - 1e-4)
    writes = sum(1 for t in hst_times(rec["hst"][0]) if t < t_first)
    return 4 * flat + 2 * (2 + writes)


def amr_expect(label, launches, rec, n, use):
    """The exact launches of an adaptive run: the pool route J three
    times a stage; block_pool=false A twice a cycle on the flat tree and
    J three times a stage on a refined one, G as ``pool_fill_expect``
    says; hydro none; Z4c H four times a cycle while flat."""
    flat = rec["flat_cycles"]
    expect = {k: 0 for k in launches}
    if use == "true":
        if label.startswith("blast_amr"):
            if "nopool" in label:
                expect["mega_stage_v2"] = 2 * flat
                expect["fused_flux_dir"] = 6 * (n - flat)
                expect["pool_fill"] = pool_fill_expect(rec, n)
            else:
                expect["fused_flux_dir"] = 6 * n
        elif label.startswith("z4c"):
            expect["z4c_stage"] = 4 * flat
    if launches != expect:
        raise AssertionError(f"{label} use_kernels={use}: launches "
                             f"{launches}, not {expect} ({flat} flat "
                             f"cycles of {n})")


def amr_flat_checks(torch, card):
    """Kernels A and G on blast_amr's flat tree with block_pool=false: 64
    blocks of 16^3 ([64, 5, 20^3] with ghosts).  A against its plain
    version on both RK2 stages of the state after AMR_FLAT_CYCLES cycles
    (f32 two-tier on each channel's scale over the pool, floor counts and
    dtmin; f64 within TAIL_STAGE_TOL of the stage's max|change|), and G
    bitwise against its plain version on the pool's cell and face arrays
    in f32 and f64; the times, plain times and bounds of both in f32."""
    from athenak_tpu_torch.ops import stage
    out = {"stage_err": 0.0, "stage_change": {}}
    for prec in ("single", "double"):
        state, phys = deck_state(torch, BLAST_AMR, AMR_NOPOOL, prec,
                                 AMR_FLAT_CYCLES)
        if phys.multilevel or phys.mesh.nmb_total != 64 or \
                not phys.use_mega_v2 or not phys.bvals.use_pool_fill:
            raise AssertionError("the flat blast_amr pool is not on "
                                 "kernel A's route")
        u0, b0, dt = state["u"], state["bfc"], phys.mesh.dt
        inp_u, inp_b = u0, b0
        for s, (g0, g1, beta) in enumerate(((0.0, 1.0, 1.0),
                                            (0.5, 0.5, 0.5))):
            bdt = torch.tensor(beta, dtype=u0.dtype) \
                * torch.tensor(dt, dtype=u0.dtype)
            args = (inp_u, inp_b, u0, b0, phys.eos, g0, g1,
                    card_step(torch, bdt, u0), phys.dxs)
            uk, bk, ck = stage.mega_stage_v2(*args)
            up, bp, cp = stage.mega_stage_v2_plain(*args)
            torch.cuda.synchronize()
            tag = f"blast_amr flat stage {s + 1} {prec}"
            if prec == "single":
                # each channel over the pool: the ambient blocks hold
                # no momentum
                uscale = interior(up).abs().amax(
                    dim=(0, -3, -2, -1), keepdim=True).clamp(min=1e-30)
                bscale = max(float(interior(bp[c]).abs().max()) for c in bp)
                out["stage_err"] = max(out["stage_err"], two_tier(
                    interior(uk), interior(up), uscale, f"{tag} u"))
                for c in bp:
                    out["stage_err"] = max(out["stage_err"], two_tier(
                        interior(bk[c]), interior(bp[c]), bscale,
                        f"{tag} {c}"))
                for key in ("neos_dfloor", "neos_efloor", "neos_tfloor"):
                    if int(ck[key]) != int(cp[key]):
                        raise AssertionError(f"{tag} {key}: {int(ck[key])} "
                                             f"!= {int(cp[key])}")
                rtol = 1e-4
            else:
                diff = {"u": change_diff(uk, up, inp_u)[1]}
                bchange = max(float((interior(bp[c]) - interior(inp_b[c]))
                                    .abs().max()) for c in bp)
                for c in bp:
                    diff[c] = float((interior(bk[c]) - interior(bp[c]))
                                    .abs().max()) / max(bchange, 1e-30)
                if not max(diff.values()) <= TAIL_STAGE_TOL:
                    raise AssertionError(f"{tag}: kernel A and its plain "
                                         f"version apart by {diff} of the "
                                         f"change")
                out["stage_change"][f"stage {s + 1}"] = max(diff.values())
                rtol = 1e-10
            dk, dp = float(ck["dtmin"]), float(cp["dtmin"])
            if abs(dk - dp) > rtol * abs(dp):
                raise AssertionError(f"{tag} dtmin {dk!r} vs {dp!r}")
            inp_u, inp_b = fill_plain(phys, up, bp)
        if prec == "single":
            args = (u0, b0, u0, b0, phys.eos, 0.0, 1.0,
                    card_step(torch, dt, u0), phys.dxs)
            out["stage_ms"] = cuda_ms(lambda: stage.mega_stage_v2(*args), 20)
            out["stage_plain_ms"] = cuda_ms(
                lambda: stage.mega_stage_v2_plain(*args), 3)
            out["stage_bound"] = bound(3 * nbytes(u0, *b0.values()),
                                       OPS_MEGA * interior(u0[:, 0]).numel())
            out["stage_shape"] = list(u0.shape)
            mesh = phys.mesh
        del state, u0, b0, inp_u, inp_b, uk, bk, up, bp
    out["fill_err"], nbr, arrs = pool_fill_pair(torch, mesh,
                                                "blast_amr flat")
    out["fill"] = pool_fill_times(torch, mesh, nbr, arrs)
    print(f"phase 17: mega_stage_v2 agrees with its plain version on "
          f"blast_amr's flat {out['stage_shape']} pool after "
          f"{AMR_FLAT_CYCLES} cycles (both RK2 stages; f32 two-tier, f64 "
          f"max |difference| over the stage's max|change| "
          f"{out['stage_change']}, limit {TAIL_STAGE_TOL}), [{card}] "
          f"{out['stage_ms']:.4f} ms/stage, plain "
          f"{out['stage_plain_ms']:.4f}, bound "
          f"{out['stage_bound'][0]:.4f}; pool_fill bitwise equal to its "
          f"plain version there (f32, f64; cell and face arrays), u "
          f"{out['fill']['ms']:.4f} ms ({out['fill']['ghosts']} ghosts), "
          f"face field {out['fill']['fc_ms']:.4f} ms, plain "
          f"{out['fill']['plain_ms']:.4f}, torch.take "
          f"{out['fill']['library_ms']:.4f}, bound "
          f"{out['fill']['bound'][0]:.5f}")
    return out


def amr_kernel_checks(torch, card, state, phys):
    """Kernel J against its plain version on a refined blast's state
    ([nmb, 5, 20^3] with ghosts; f32 two-tier, f64 1e-10) and kernel H
    against its plain version on the flat 64 x 8^3 ng 4 Z4c pool (the
    four RK4 stages, f32 2e-5, f64 1e-10); times of both in f32."""
    from athenak_tpu_torch.ops import flux
    from athenak_tpu_torch.ops import z4c_stage as zs
    out = {"flux_dir_shape": list(state["w"].shape), "flux_dir_err": 0.0}
    for dtype in (torch.float32, torch.float64):
        w, bcc = state["w"].to(dtype), state["bcc"].to(dtype)
        bfc = {k: v.to(dtype) for k, v in state["bfc"].items()}
        for name, _axis, ivx, _dx in phys.dirs:
            args = (w, bcc, bfc[f"{name}f"], phys.eos, name, ivx)
            got = flux.fused_flux_dir(*args)
            ref = flux.flux_dir_plain(*args)
            for g, r in zip(got, ref):
                g, r = faces(g), faces(r)
                scale = float(r.abs().max()) or 1.0
                if dtype == torch.float32:
                    out["flux_dir_err"] = max(out["flux_dir_err"], two_tier(
                        g, r, scale, f"amr fused_flux_dir {name}"))
                elif float((g - r).abs().max()) / scale > 1e-10:
                    raise AssertionError(f"amr fused_flux_dir {name} f64")
            if dtype == torch.float32 and name == "x1":
                cells = w[:, 0].numel()
                out["flux_dir_ms"] = cuda_ms(
                    lambda: flux.fused_flux_dir(*args), 20)
                out["flux_dir_plain_ms"] = cuda_ms(
                    lambda: flux.flux_dir_plain(*args), 3)
                out["flux_dir_bound"] = bound(
                    15 * cells * w.element_size(), OPS_FACE["hlld"] * cells)
    out["z4c_err"] = 0.0
    for prec in ("single", "double"):
        zphys, u, u1, dt = z4c_inputs(torch, Z4C_AMR, [], prec)
        if not zphys.use_stage_kernel or zphys.mesh.nmb_total != 64:
            raise AssertionError("the flat Z4c AMR pool is not on kernel "
                                 "H's route")
        tol = 2e-5 if prec == "single" else 1e-10
        for g0, g1, bdt in rk4_sets(torch, u.dtype, dt):
            a = interior(zs.fused_z4c_stage(u, u1, zphys, g0, g1, bdt),
                         4).double()
            b = interior(zs.fused_z4c_stage_plain(u, u1, zphys, g0, g1,
                                                  bdt), 4).double()
            rel = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
            if not rel <= tol:
                raise AssertionError(f"amr z4c_stage {prec}: {rel:g}")
            if prec == "single":
                out["z4c_err"] = max(out["z4c_err"],
                                     float((a - b).abs().max()))
        if prec == "single":
            args = (u, u1, zphys) + rk4_sets(torch, u.dtype, dt)[1]
            out["z4c_ms"] = cuda_ms(lambda: zs.fused_z4c_stage(*args), 20)
            out["z4c_plain_ms"] = cuda_ms(
                lambda: zs.fused_z4c_stage_plain(*args), 2)
            out["z4c_bound"] = z4c_bound(zphys, u)
            out["z4c_shape"] = list(u.shape)
    print(f"phase 17: fused_flux_dir agrees with its plain version on the "
          f"refined blast {out['flux_dir_shape']} (f32 two-tier, f64 "
          f"1e-10), [{card}] x1 {out['flux_dir_ms']:.4f} ms, plain "
          f"{out['flux_dir_plain_ms']:.4f}, bound "
          f"{out['flux_dir_bound'][0]:.4f}; z4c_stage on the flat "
          f"{out['z4c_shape']} pool (f32 2e-5, f64 1e-10) "
          f"{out['z4c_ms']:.4f} ms, plain {out['z4c_plain_ms']:.3f}, bound "
          f"{out['z4c_bound'][0]:.4f}")
    return out


def amr_restart(torch, kernels):
    """blast_amr on the pool route: 2 x 14 cycles straight against 14, a
    .rst, then -r and 14 more: the trees equal and u and the face field
    bitwise equal; the tree refined by cycle 14 (the deck's first update
    comes at cycle 12)."""
    from athenak_tpu_torch import main as cli_main
    from athenak_tpu_torch.outputs import load_restart
    n = 14
    common = ["output9/file_type=rst", f"output9/dcycle={n}"]
    cwd = os.getcwd()
    os.environ["ATHENAK_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        try:
            m1, _, _, s1 = cli_main.cli([
                "-i", BLAST_AMR, "-d", os.path.join(tmp, "straight"),
                *common, f"time/nlim={2 * n}"])
            os.chdir(cwd)
            cli_main.cli(["-i", BLAST_AMR, "-d", os.path.join(tmp, "first"),
                          *common, f"time/nlim={n}"])
            os.chdir(cwd)
            rst = os.path.join(tmp, "first", "BlastAMR.00001.rst")
            extras = load_restart(rst, with_extras=True)[5]
            kernels.reset_counts()
            m2, _, _, s2 = cli_main.cli([
                "-r", rst, "-d", os.path.join(tmp, "first"),
                f"time/nlim={2 * n}"])
            resumed = {k.name: k.launches for k in kernels.ALL if k.launches}
        finally:
            os.chdir(cwd)
    lev10 = max(leaf[3] for leaf in extras["tree_leaves"])
    if lev10 < 1:
        raise AssertionError("blast_amr restart: the tree is flat at cycle "
                             f"{n}")
    if m1.leaves != m2.leaves or m2.ncycle != 2 * n:
        raise AssertionError("blast_amr restart: trees differ")
    for key in ["u"] + [f"bfc/{c}" for c in s1["bfc"]]:
        a = s1[key] if "/" not in key else s1["bfc"][key[4:]]
        b = s2[key] if "/" not in key else s2["bfc"][key[4:]]
        if not torch.equal(a, b):
            raise AssertionError(f"blast_amr restart: {key} not bitwise")
    print(f"phase 17: restart blast_amr: {2 * n} cycles straight and {n} + "
          f"-r {n} bitwise equal (u, face field), trees equal "
          f"({m2.nmb_total} blocks, levels up to {lev10} at cycle {n}); "
          f"launches resumed {resumed}")
    return {"resumed": resumed, "nmb": m2.nmb_total}


def phase_amr(torch, kernels, card):
    """The adaptive decks through the CLI (see the module docstring)."""
    from athenak_tpu_torch.main import build
    out = {}
    kchecks = None
    for label, deck, block, n, extra in AMR_RUNS:
        mesh0, _, _, _, st0 = build(pin_for(extra, deck), device="cuda")
        mass0 = volume_mass(torch, mesh0, st0["u"])
        alpha0 = float(interior(st0["u"][:, 18], 4).min()) \
            if block == "z4c" else None
        del st0
        res = {}
        for use in ("true", "false"):
            launches, mesh, phys, driver, state, rec = amr_cli(
                torch, kernels, deck, n,
                extra + [f"{block}/use_kernels={use}"])
            amr_expect(label, launches, rec, n, use)
            if not bool(torch.isfinite(state["u"]).all()):
                raise AssertionError(f"{label} {use}: non-finite state")
            if label != "hydro_amr" and not rec["trees"]:
                raise AssertionError(f"{label} {use}: no tree update")
            info = {"launches": launches, "trees": rec["trees"],
                    "flat_cycles": rec["flat_cycles"],
                    "levels": sorted(set(mesh.mb_lev.tolist())),
                    "nmb": mesh.nmb_total, "zcps": driver.zcps,
                    "divb_updates": rec["divb"],
                    "timings": rec["timings"]}
            if block == "z4c":
                u = state["u"]
                chi = float(interior(u[:, 0], 4).min())
                alpha = float(interior(u[:, 18], 4).min())
                if chi < phys.opt.chi_min_floor or not 0.0 < alpha < 1.0:
                    raise AssertionError(f"{label} {use}: chi {chi}, lapse "
                                         f"at the puncture {alpha}")
                info.update(chi_min=chi, lapse=(alpha0, alpha))
            else:
                dmass = abs(volume_mass(torch, mesh, state["u"]) - mass0) \
                    / mass0
                if dmass > 1e-5:
                    raise AssertionError(f"{label} {use}: mass drift "
                                         f"{dmass:g}")
                info["dmass"] = dmass
                if "bfc" in state:
                    info["divb"] = check_levels(torch, mesh, state, label)
            res[use] = (info, mesh, phys, state)
            print(f"phase 17: {label} use_kernels={use}: {n} cycles "
                  f"({rec['flat_cycles']} on a flat tree), "
                  f"{len(rec['trees'])} tree updates at cycles "
                  f"{[c for c, _ in rec['trees']]}, {mesh.nmb_total} blocks "
                  f"at the end on levels {info['levels']}, launches "
                  f"{launches}, div(B) by level after each update "
                  f"{rec['divb']}, {info.get('dmass', '')} mass drift; "
                  f"[{card}] CLI zone-cycles/s {driver.zcps:.6e} (wall "
                  f"clock, AMR steps included); per update host ms "
                  f"{rec['timings']}")
        (ki, km, kp, ks), (pi, pm, pp, ps) = res["true"], res["false"]
        if ki["trees"] != pi["trees"]:
            raise AssertionError(f"{label}: the paths took different trees")
        if block == "z4c":
            a, b = ks["u"].double(), ps["u"].double()
            diff = {"u": float(((a - b).abs()
                                / b.abs().clamp(min=1.0)).max())}
            if not diff["u"] <= Z4C_PATH_TOL:
                raise AssertionError(f"{label}: paths apart {diff}")
        else:
            pairs = [("u", ks["u"], ps["u"])] + [
                (c, ks["bfc"][c], ps["bfc"][c]) for c in ks.get("bfc", {})]
            diff = {k: range_diff(a, b) for k, a, b in pairs}
            for k, d in diff.items():
                if not (d[0] > 0.95 and d[1] < SMR_PATH_TOL[1]):
                    raise AssertionError(f"{label}: paths apart in {k}: {d}")
        parts = None
        if label == "blast_amr":
            parts = smr_stage_parts(torch, kp, ks, km.dt)
            kchecks = amr_kernel_checks(torch, card, ks, kp)
        del res, ks, ps
        if label == "blast_amr_nopool":
            print(f"phase 17: {label}: pool_fill {ki['launches']['pool_fill']}"
                  f" = 4 x {ki['flat_cycles']} flat cycles + 2 x (initial "
                  f"fill, first dt, history rows before the first update)")
            kchecks.update(flat=amr_flat_checks(torch, card))
        rates = {"true": [ki["zcps"]], "false": [pi["zcps"]]}
        print(f"phase 17: [{card}] {label} kernel vs plain path {diff}; "
              f"zone-cycles/s (wall clock of the CLI runs) kernel "
              f"{rates['true']}, plain "
              f"{rates['false']}; one stage's parts on the final tree, ms "
              f"{parts}")
        out[label] = {"launches": ki["launches"], "rates": rates,
                      "parts": parts, "path_diff": diff,
                      "trees": [(c, len(t)) for c, t in ki["trees"]],
                      "levels": ki["levels"], "nmb": ki["nmb"],
                      "flat_cycles": ki["flat_cycles"],
                      "timings_ms": ki["timings"]}
    return {"runs": out, "checks": kchecks}


def z4c_expect(launches, label, **counts):
    expect = {k: 0 for k in launches}
    expect.update(counts)
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches}, not {expect}")


def z4c_paths_apart(a, b):
    """max |a - b| / max(|b|, 1) over two states (Z4C_PATH_TOL's
    measure)."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def check_z4c_state(torch, phys, state, label):
    """A finite state with chi above its floor; returns min chi."""
    u = state["u"]
    if not bool(torch.isfinite(u).all()):
        raise AssertionError(f"{label}: non-finite state")
    chi = float(interior(u[:, 0], phys.ng).min())
    if chi < phys.opt.chi_min_floor:
        raise AssertionError(f"{label}: chi {chi} below its floor")
    return chi


def ham_norm(torch, phys, u):
    """The L2 norm of the Hamiltonian constraint over the interior."""
    H, _ = phys.adm_constraints(u)
    return float(interior(H[:, None], phys.ng).double().pow(2).mean()
                 .sqrt())


def sor_numpy(domain, centers, masses, Ps, N, iters, omega=1.8):
    """The JAX package's red-black SOR for the two-puncture correction
    in numpy (``athenak_tpu/pgen/z4c_two_punctures.py:57-99``, spins 0),
    the plain version the port's torch sweeps are held against."""
    import numpy as np
    from athenak_tpu_torch.pgen.z4c_two_punctures import _bowen_york
    from athenak_tpu_torch.z4c.z4c import sym_idx
    x0, x1, y0, y1, z0, z1 = domain
    xs, ys, zs = (np.linspace(a, b, N) for a, b in ((x0, x1), (y0, y1),
                                                    (z0, z1)))
    h = xs[1] - xs[0]
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    psi = 1.0 + sum(m / (2.0 * np.maximum(np.sqrt(
        (X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2), 1e-12))
        for m, c in zip(masses, centers))
    At = _bowen_york([X, Y, Z], masses, centers, Ps, [[0.0] * 3] * 2)
    Asq = sum((1.0 if a == b else 2.0) * At[sym_idx(a, b)] ** 2
              for a in range(3) for b in range(a, 3))
    u = np.zeros_like(X)
    ii, jj, kk = np.meshgrid(*(np.arange(N),) * 3, indexing="ij")
    red = (ii + jj + kk) % 2 == 0
    inner = np.zeros_like(red)
    inner[1:-1, 1:-1, 1:-1] = True
    for _ in range(iters // 2):
        for mask in (red, ~red):
            rhs = -(1.0 / 8.0) * Asq * (psi + u) ** (-7.0)
            nb = sum(np.roll(u, s, ax) for ax in range(3) for s in (1, -1))
            gs = (nb - h * h * rhs) / 6.0
            m = mask & inner
            u[m] = (1.0 - omega) * u[m] + omega * gs[m]
    return u


def bbh_sor(torch):
    """The two-puncture SOR of the flat binary (``tp_npoints`` 64,
    ``tp_iterations`` 4000): ms of the torch sweeps on the card, and of
    the numpy sweeps on the host over BBH_SOR_HOST_ITERS half-sweeps
    (scaled to 4000: a half-sweep costs the same throughout); the two
    within 1e-12 of max|u| after BBH_SOR_HOST_ITERS half-sweeps."""
    from athenak_tpu_torch.pgen.z4c_two_punctures import _solve_u
    # the domain, centres, masses and momenta of BBH_FLAT
    args = ((-16.0, 16.0, -16.0, 16.0, -16.0, 16.0),
            [[3.0, 0.0, 0.0], [-3.0, 0.0, 0.0]], [0.5, 0.5],
            [[0.0, -0.1, 0.0], [0.0, 0.1, 0.0]])
    spins = [[0.0] * 3] * 2
    _solve_u(*args, spins, N=64, iters=2, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = _solve_u(*args, spins, N=64, iters=4000, device="cuda")
    torch.cuda.synchronize()
    card_ms = 1e3 * (time.perf_counter() - t0)
    short = _solve_u(*args, spins, N=64, iters=BBH_SOR_HOST_ITERS,
                     device="cuda")[3]
    t0 = time.perf_counter()
    ref = sor_numpy(*args, N=64, iters=BBH_SOR_HOST_ITERS)
    host_ms = 1e3 * (time.perf_counter() - t0)
    scale = float(abs(ref).max())
    err = float(abs(short - ref).max()) / scale
    if not err <= 1e-12:
        raise AssertionError(f"two-puncture SOR on the card vs numpy: {err}")
    return {"card_ms": card_ms, "numpy_ms": host_ms,
            "numpy_ms_4000": host_ms * 4000 / BBH_SOR_HOST_ITERS,
            "err": err, "max_u": float(abs(full[3]).max())}


def bbh_stage_checks(torch, card):
    """On the flat binary's initialised state at 128^3 (one block of
    136^3 with ghosts): ||H||_2, the ms of ``weyl_scalars`` and
    ``adm_constraints``; kernel H against its plain version on the state
    with noise (one RK4 set; f32 2e-5, f64 1e-10) and kernel I bitwise
    against the sweeps on H's output; H's and I's times."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import z4c_stage as zs
    from athenak_tpu_torch.z4c.weyl import weyl_scalars
    out = {"err": 0.0}
    for prec in ("single", "double"):
        mesh, phys, _, driver, st = build(
            pin_for([f"job/precision={prec}", *BBH_FLAT], BBH),
            device="cuda")
        st = driver.initialize(st)
        u0 = st["u"]
        if tuple(u0.shape) != (1, 22, 136, 136, 136) or not phys.fold_bc:
            raise AssertionError(f"bbh_flat: {tuple(u0.shape)}, fold "
                                 f"{phys.fold_bc}")
        if prec == "single":
            out["H2_0"] = ham_norm(torch, phys, u0)
            out["weyl_ms"] = cuda_ms(lambda: weyl_scalars(phys, u0), 3)
            out["con_ms"] = cuda_ms(lambda: phys.adm_constraints(u0), 3)
            out["con_full_ms"] = cuda_ms(
                lambda: phys.adm_constraints(u0, full=True), 3)
        gen = torch.Generator(device="cuda").manual_seed(14)
        u = u0.double() + 1e-3 * torch.randn(u0.shape, generator=gen,
                                             device="cuda",
                                             dtype=torch.float64)
        u1 = (u * (1.0 + 1e-3 * torch.randn(
            u0.shape, generator=gen, device="cuda",
            dtype=torch.float64))).to(u0.dtype)
        u = u.to(u0.dtype)
        del st, u0
        g0, g1, bdt = rk4_sets(torch, u.dtype, mesh.dt)[1]
        got = zs.fused_z4c_stage(u, u1, phys, g0, g1, bdt)
        want = zs.fused_z4c_stage_plain(u, u1, phys, g0, g1, bdt)
        a, b = interior(got, 4).double(), interior(want, 4).double()
        rel = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
        tol = 2e-5 if prec == "single" else 1e-10
        if not rel <= tol:
            raise AssertionError(f"bbh_flat z4c_stage {prec}: {rel:g}")
        del a, b, want
        k = zs.outflow_fill(got.clone(), phys.bvals)
        p = phys.bvals.fill_ghosts(got.clone())
        if not (torch.equal(k, p) and bool(torch.isfinite(k).all())):
            raise AssertionError(f"bbh_flat z4c_outflow_fill {prec}: not "
                                 "bitwise")
        del k, p
        out[f"rel_{prec}"] = rel
        if prec == "single":
            out["err"] = rel
            args = (u, u1, phys, g0, g1, bdt)
            out["ms"] = cuda_ms(lambda: zs.fused_z4c_stage(*args), 10)
            out["plain_ms"] = cuda_ms(
                lambda: zs.fused_z4c_stage_plain(*args), 1)
            out["bound"] = z4c_bound(phys, u)
            out["fill_ms"] = cuda_ms(
                lambda: zs.outflow_fill(got, phys.bvals), 20)
            out["fill_plain_ms"] = cuda_ms(
                lambda: phys.bvals.fill_ghosts(got), 3)
            out["fill_bound"] = outflow_fill_bound(phys, got)
        del u, u1, got
    print(f"phase 18: bbh_flat z4c_stage agrees with its plain version at "
          f"[1, 22, 136^3] (f32 {out['rel_single']:.3e}, f64 "
          f"{out['rel_double']:.3e}), z4c_outflow_fill bitwise; [{card}] "
          f"z4c_stage {out['ms']:.4f} ms, plain {out['plain_ms']:.1f} ms, "
          f"bound {out['bound'][0]:.4f} ms ({out['bound'][1]}); "
          f"z4c_outflow_fill {out['fill_ms']:.4f} ms, plain "
          f"{out['fill_plain_ms']:.3f}, bound {out['fill_bound'][0]:.5f}; "
          f"weyl_scalars {out['weyl_ms']:.2f} ms a call, adm_constraints "
          f"{out['con_ms']:.2f} (full {out['con_full_ms']:.2f}); ||H||_2 at "
          f"t = 0 {out['H2_0']:.4e}")
    return out


def bbh_flat(torch, kernels, card):
    """The flat binary at 128^3 through the CLI in f32 for NCYC_BBH
    cycles on both paths: H and I 4 a cycle on the kernel path, nothing
    on the plain one; the paths within Z4C_PATH_TOL, the trackers within
    1e-4 of the separation and moved; ||H||_2 finite and grown less than
    10x; the waveform rows written."""
    sor = bbh_sor(torch)
    print(f"phase 18: two-puncture SOR (64^3, 4000 half-sweeps) [{card}] "
          f"{sor['card_ms']:.0f} ms on the card; numpy on the host "
          f"{sor['numpy_ms']:.0f} ms for {BBH_SOR_HOST_ITERS} half-sweeps "
          f"({sor['numpy_ms_4000']:.0f} ms scaled to 4000); the two within "
          f"{sor['err']:.2e} of max|u| after {BBH_SOR_HOST_ITERS}")
    checks = bbh_stage_checks(torch, card)
    runs = {}
    for use in ("true", "false"):
        launches, mesh, phys, driver, state, written = cli_run(
            torch, kernels, BBH, NCYC_BBH,
            ["job/precision=single", *BBH_FLAT, f"z4c/use_kernels={use}"])
        n = 4 * NCYC_BBH if use == "true" else 0
        z4c_expect(launches, f"bbh_flat use_kernels={use}", z4c_stage=n,
                   z4c_outflow_fill=n)
        chi = check_z4c_state(torch, phys, state, f"bbh_flat {use}")
        rows = [ln for ln in written["two_puncture_trackers.waveform.txt"]
                .splitlines() if not ln.startswith("#")]
        runs[use] = (launches, state, driver.zcps, chi, len(rows))
    launches, state, zcps, chi, nrows = runs["true"]
    plain = runs["false"][1]
    diff = z4c_paths_apart(state["u"], plain["u"])
    dpos = float((state["co_pos"] - plain["co_pos"]).abs().max())
    if not (diff <= Z4C_PATH_TOL and dpos <= 1e-4 * 6.0):
        raise AssertionError(f"bbh_flat: paths apart {diff:g}, trackers "
                             f"{dpos:g}")
    moved = state["co_pos"].double().cpu().numpy() - phys.tracker_pos0
    h2 = ham_norm(torch, phys, state["u"])
    if not (abs(moved).max() > 0.0 and math.isfinite(h2)
            and h2 <= 10.0 * checks["H2_0"] and nrows >= 2):
        raise AssertionError(f"bbh_flat: trackers moved {moved.tolist()}, "
                             f"||H||_2 {checks['H2_0']:g} -> {h2:g}, "
                             f"{nrows} waveform rows")
    print(f"phase 18: bbh_flat {NCYC_BBH} cycles, launches {launches}; "
          f"chi >= {chi:.4e}; trackers moved {moved.tolist()}; ||H||_2 "
          f"{checks['H2_0']:.4e} -> {h2:.4e}; {nrows} waveform rows; "
          f"kernel vs plain path {diff:.3e}, trackers {dpos:.3e}; [{card}] "
          f"CLI zone-cycles/s (wall clock, first cycle and two wave "
          f"outputs included) kernel {zcps:.6e}, plain "
          f"{runs['false'][2]:.6e}")
    return {"launches": launches, "sor": sor, "checks": checks,
            "rates": {"true": [zcps], "false": [runs["false"][2]]},
            "path_diff": diff, "tracker_diff": dpos, "H2": h2,
            "moved": moved.tolist()}


def tracker_levels(leaves, pos, lo=-100.0, width=200.0, nroot=4):
    """The finest level among the leaves whose box holds ``pos`` (the
    shipped BBH deck's 4^3 root blocks on [-100, 100]^3)."""
    best = -1
    for l1, l2, l3, lev in leaves:
        w = width / (nroot << lev)
        if all(lo + l * w <= p <= lo + (l + 1) * w
               for l, p in zip((l1, l2, l3), pos)):
            best = max(best, lev)
    return best


def bbh_amr(torch, kernels, card):
    """``two_puncture_trackers.athinput`` as shipped (tracker AMR to 5
    levels) in f32 for NCYC_BBH_AMR cycles, both paths: the same trees,
    each update one level finer at both trackers (up to co_N_reflevel),
    H 4 a cycle while flat, the paths within Z4C_PATH_TOL, the waveform
    rows written."""
    res = {}
    for use in ("true", "false"):
        launches, mesh, phys, driver, state, rec = amr_cli(
            torch, kernels, BBH, NCYC_BBH_AMR,
            BBH_AMR + [f"z4c/use_kernels={use}"])
        amr_expect("z4c_bbh", launches, rec, NCYC_BBH_AMR, use)
        chi = check_z4c_state(torch, phys, state, f"bbh_amr {use}")
        for n, (c, leaves) in enumerate(rec["trees"]):
            got = [tracker_levels(leaves, p) for p in phys.tracker_pos0]
            want = min(n + 1, int(phys.tracker_reflevel.max()))
            if got != [want, want]:
                raise AssertionError(f"bbh_amr {use}: the update of cycle "
                                     f"{c} put the trackers on levels "
                                     f"{got}, not {want}")
        rows = [ln for ln in rec["txt"]["two_puncture_trackers.waveform.txt"]
                .splitlines() if not ln.startswith("#")]
        if len(rows) < 2:
            raise AssertionError(f"bbh_amr {use}: {len(rows)} waveform rows")
        res[use] = (rec, state, driver.zcps, launches, chi, len(rows),
                    mesh.nmb_total)
    if res["true"][0]["trees"] != res["false"][0]["trees"]:
        raise AssertionError("bbh_amr: the paths took different trees")
    diff = z4c_paths_apart(res["true"][1]["u"], res["false"][1]["u"])
    if not diff <= Z4C_PATH_TOL:
        raise AssertionError(f"bbh_amr: paths apart {diff:g}")
    rec, _, zcps, launches, chi, nrows, nmb = res["true"]
    print(f"phase 18: bbh_amr {NCYC_BBH_AMR} cycles "
          f"({rec['flat_cycles']} flat), tree updates at cycles "
          f"{[c for c, _ in rec['trees']]} to "
          f"{[len(t) for _, t in rec['trees']]} blocks, launches "
          f"{launches}, chi >= {chi:.4e}, {nrows} waveform rows, kernel vs "
          f"plain path {diff:.3e}; [{card}] CLI zone-cycles/s kernel "
          f"{zcps:.6e}, plain {res['false'][2]:.6e}; per update host ms "
          f"{rec['timings']}")
    return {"launches": launches, "path_diff": diff, "nmb": nmb,
            "rates": {"true": [zcps], "false": [res["false"][2]]},
            "trees": [(c, len(t)) for c, t in rec["trees"]]}


def bbh_restart(torch, kernels):
    """The flat binary at 64^3 in f32: NCYC_BBH_RST cycles straight
    against half, a .rst, then -r and the rest: u and the trackers
    bitwise."""
    from athenak_tpu_torch import main as cli_main
    n = NCYC_BBH_RST // 2
    common = ["job/precision=single", *BBH_RST, "output9/file_type=rst",
              f"output9/dcycle={n}"]
    cwd = os.getcwd()
    os.environ["ATHENAK_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        try:
            _, _, _, s1 = cli_main.cli(["-i", BBH, "-d",
                                        os.path.join(tmp, "straight"),
                                        *common, f"time/nlim={2 * n}"])
            os.chdir(cwd)
            cli_main.cli(["-i", BBH, "-d", os.path.join(tmp, "first"),
                          *common, f"time/nlim={n}"])
            os.chdir(cwd)
            rst = os.path.join(tmp, "first",
                               "two_puncture_trackers.00001.rst")
            kernels.reset_counts()
            m2, _, _, s2 = cli_main.cli(["-r", rst, "-d",
                                         os.path.join(tmp, "first"),
                                         f"time/nlim={2 * n}"])
            resumed = {k.name: k.launches for k in kernels.ALL if k.launches}
        finally:
            os.chdir(cwd)
    for key in ("u", "co_pos"):
        if not torch.equal(s1[key], s2[key]):
            raise AssertionError(f"bbh restart: {key} not bitwise")
    if m2.ncycle != 2 * n or s2["co_pos"].dtype != torch.float32:
        raise AssertionError("bbh restart: wrong run")
    print(f"phase 18: restart bbh_flat 64^3: {2 * n} cycles straight and "
          f"{n} + -r {n} bitwise equal (u, co_pos {s2['co_pos'].tolist()}); "
          f"launches resumed {resumed}")
    return {"resumed": resumed}


def z4c_slice_decks(torch, kernels, card):
    """kerr_schild and one_puncture_ahf as shipped in f32 for
    NCYC_Z4C_SLICE cycles, both paths (H and I once a stage, exact; the
    paths within Z4C_PATH_TOL); FastFlow on one_puncture_ahf's initial
    data at tests/test_ahf.py's mesh and settings."""
    out = {}
    for label, deck, nstage in (("kerr_schild", KERR, 3),
                                ("one_puncture_ahf", AHF1, 4)):
        runs = {}
        for use in ("true", "false"):
            launches, mesh, phys, driver, state, _ = cli_run(
                torch, kernels, deck, NCYC_Z4C_SLICE,
                ["job/precision=single", f"z4c/use_kernels={use}"])
            n = nstage * NCYC_Z4C_SLICE if use == "true" else 0
            z4c_expect(launches, f"{label} use_kernels={use}", z4c_stage=n,
                       z4c_outflow_fill=n)
            chi = check_z4c_state(torch, phys, state, f"{label} {use}")
            runs[use] = (launches, state, driver.zcps, chi)
        diff = z4c_paths_apart(runs["true"][1]["u"], runs["false"][1]["u"])
        if not diff <= Z4C_PATH_TOL:
            raise AssertionError(f"{label}: paths apart {diff:g}")
        shape = list(runs["true"][1]["u"].shape)
        print(f"phase 18: {label} {shape} {NCYC_Z4C_SLICE} cycles, launches "
              f"{runs['true'][0]}, chi >= {runs['true'][3]:.4e}, kernel vs "
              f"plain path {diff:.3e}; [{card}] CLI zone-cycles/s kernel "
              f"{runs['true'][2]:.6e}, plain {runs['false'][2]:.6e}")
        out[label] = {"launches": runs["true"][0], "path_diff": diff,
                      "rates": {"true": [runs["true"][2]],
                                "false": [runs["false"][2]]}}
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.z4c.ahf import FastFlow, adm_fields_from_z4c
    mesh, phys, _, driver, st = build(pin_for(AHF_FIND, AHF1),
                                      device="cuda")
    st = driver.initialize(st)
    t0 = time.perf_counter()
    fields = adm_fields_from_z4c(phys, st["u"])
    t1 = time.perf_counter()
    props = FastFlow(lmax=6, ntheta=16, flow_iterations=300).find(
        mesh, fields, r_guess=0.7)
    t2 = time.perf_counter()
    if props is None or not (abs(props["mass_irr"] - 1.0) < 0.01
                             and abs(props["mean_radius"] - 0.5) < 0.03):
        raise AssertionError(f"FastFlow on one_puncture_ahf: {props}")
    print(f"phase 18: FastFlow on one_puncture_ahf's initial data (64^3 on "
          f"[-2, 2]^3, nghost 4, f64): M_irr {props['mass_irr']:.6f}, mean "
          f"radius {props['mean_radius']:.6f}, {props['iterations']} "
          f"iterations; ADM fields {1e3 * (t1 - t0):.0f} ms (card + copy), "
          f"the finder {1e3 * (t2 - t1):.0f} ms on the host")
    out["ahf"] = {k: props[k] for k in ("mass_irr", "mean_radius",
                                        "iterations")}
    return out


def awa_decks(torch, kernels, card, fill):
    """The AwA decks: kernel B bitwise at gauge_wave's and robust
    stability's block shapes on 22 channels; kernel H against its plain
    version at gauge_wave's [1, 22, 12, 12, 72] (nghost 4); gauge_wave in
    f32 through the CLI on both paths (H 3 a stage; B's gate takes
    nghost 2 only, as the JAX package's); robust_stability in f64 (the
    plain path: its 1e-10 noise is below f32's resolution of 1) and in
    f32 (H 3 a cycle, B once more than that)."""
    from athenak_tpu_torch.ops import z4c_stage as zs
    out = {"b": {}, "b_err": 0.0}
    gen = torch.Generator().manual_seed(18)
    for shape in ((1, 22, 12, 12, 72), (1, 22, 54, 54, 54)):
        for dtype in (torch.float32, torch.float64):
            a = torch.rand(shape, generator=gen, dtype=dtype).cuda()
            b = a.clone()
            n0 = kernels.PERIODIC_FILL_CC.launches
            fill.periodic_fill_cc(a)
            if kernels.PERIODIC_FILL_CC.launches != n0 + 1:
                raise AssertionError("periodic_fill_cc: not one launch")
            fill.fill_plain(b, fill.shifts(b.shape))
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"periodic_fill_cc {shape} {dtype}: "
                                     "not bitwise")
            out["b_err"] = max(out["b_err"], float((a - b).abs().max()))
            if dtype == torch.float32:
                ghosts = a.numel() - interior(a).numel()
                out["b"][str(list(shape))] = {
                    "ms": cuda_ms(lambda: fill.periodic_fill_cc(a), 50),
                    "plain_ms": cuda_ms(
                        lambda: fill.fill_plain(b, fill.shifts(b.shape)), 20),
                    "bound": bound(2 * ghosts * a.element_size(), 0)}
    h = {}
    for prec in ("single", "double"):
        phys, u, u1, dt = z4c_inputs(torch, GAUGE, [], prec)
        if tuple(u.shape) != (1, 22, 12, 12, 72) or phys.ng != 4:
            raise AssertionError(f"gauge_wave: {tuple(u.shape)}")
        tol = 2e-5 if prec == "single" else 1e-10
        worst = 0.0
        for g0, g1, bdt in rk4_sets(torch, u.dtype, dt):
            a = interior(zs.fused_z4c_stage(u, u1, phys, g0, g1, bdt),
                         4).double()
            b = interior(zs.fused_z4c_stage_plain(u, u1, phys, g0, g1, bdt),
                         4).double()
            rel = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
            if not rel <= tol:
                raise AssertionError(f"gauge_wave z4c_stage {prec}: {rel:g}")
            worst = max(worst, rel)
        h[prec] = worst
        if prec == "single":
            args = (u, u1, phys) + rk4_sets(torch, u.dtype, dt)[1]
            h["ms"] = cuda_ms(lambda: zs.fused_z4c_stage(*args), 50)
            h["plain_ms"] = cuda_ms(lambda: zs.fused_z4c_stage_plain(*args),
                                    3)
            h["bound"] = z4c_bound(phys, u)
    out["h"] = h
    runs = {}
    for label, deck, prec, use, nstage in (
            ("gauge_wave", GAUGE, "single", "true", 3),
            ("gauge_wave", GAUGE, "single", "false", 3),
            ("robust_stability", ROBUST, "double", "true", 3),
            ("robust_stability_f32", ROBUST, "single", "true", 3),
            ("robust_stability_f32", ROBUST, "single", "false", 3)):
        launches, mesh, phys, driver, state, _ = cli_run(
            torch, kernels, deck, NCYC_AWA,
            [f"job/precision={prec}", f"z4c/use_kernels={use}"])
        n = NCYC_AWA
        expect = {}
        if use == "true" and prec == "single":
            expect["z4c_stage"] = nstage * n
            if phys.ng == 2:
                expect["periodic_fill_cc"] = 1 + nstage * n
        z4c_expect(launches, f"{label} use_kernels={use}", **expect)
        check_z4c_state(torch, phys, state, label)
        dev = None
        if label.startswith("robust"):
            # the noise stays at its size: Gamma^i, three centred
            # differences of 1e-10 noise over dx = 0.02, starts below
            # 1.5e-8 and must stay below 2e-8; every other channel below
            # 1e-8 (f32: below 1e-6, where the noise rounds)
            flat = torch.zeros(22, dtype=torch.float64, device="cuda")
            flat[[0, 1, 4, 6, 18]] = 1.0
            d = (interior(state["u"], 2).double()
                 - flat[None, :, None, None, None]).abs().amax(
                     dim=(0, 2, 3, 4))
            gam = float(d[14:17].max())
            rest = float(torch.cat([d[:14], d[17:]]).max())
            dev = {"Gamma": gam, "other": rest}
            lim = (2e-8, 1e-8) if prec == "double" else (1e-6, 1e-6)
            if not (gam < lim[0] and rest < lim[1]):
                raise AssertionError(f"{label}: |u - Minkowski| {dev}")
        runs[(label, use)] = (launches, state, driver.zcps, dev)
    for label in ("gauge_wave", "robust_stability_f32"):
        diff = z4c_paths_apart(runs[(label, "true")][1]["u"],
                               runs[(label, "false")][1]["u"])
        if not diff <= Z4C_PATH_TOL:
            raise AssertionError(f"{label}: paths apart {diff:g}")
        out[label] = {"launches": runs[(label, "true")][0],
                      "path_diff": diff,
                      "rates": {"true": [runs[(label, "true")][2]],
                                "false": [runs[(label, "false")][2]]},
                      "dev": runs[(label, "true")][3]}
    out["robust_stability"] = {
        "launches": runs[("robust_stability", "true")][0],
        "dev": runs[("robust_stability", "true")][3],
        "rates": {"false": [runs[("robust_stability", "true")][2]]}}
    bs = "; ".join(f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, "
                   f"bound {v['bound'][0]:.6f})" for k, v in out["b"].items())
    print(f"phase 18: periodic_fill_cc bitwise on 22 channels (f32, f64), "
          f"[{card}] {bs}; z4c_stage at gauge_wave's [1, 22, 12, 12, 72] "
          f"ng 4 (f32 {h['single']:.3e}, f64 {h['double']:.3e}) "
          f"{h['ms']:.4f} ms, plain {h['plain_ms']:.2f}, bound "
          f"{h['bound'][0]:.6f}")
    for label in ("gauge_wave", "robust_stability_f32", "robust_stability"):
        r = out[label]
        print(f"phase 18: {label} {NCYC_AWA} cycles, launches "
              f"{r['launches']}, kernel vs plain path "
              f"{r.get('path_diff', 'f64: plain path only')}, max|u - "
              f"Minkowski| {r['dev']}; [{card}] CLI zone-cycles/s "
              f"{r['rates']}")
    return out


def phase_bbh(torch, kernels, card, fill):
    """Phase 18 (see the module docstring)."""
    out = {"bbh_flat": bbh_flat(torch, kernels, card),
           "bbh_amr": bbh_amr(torch, kernels, card)}
    out.update(z4c_slice_decks(torch, kernels, card))
    out["awa"] = awa_decks(torch, kernels, card, fill)
    runs = {k: out[k] for k in ("bbh_flat", "bbh_amr", "kerr_schild",
                                "one_puncture_ahf")}
    runs.update({k: out["awa"][k] for k in ("gauge_wave",
                                            "robust_stability_f32",
                                            "robust_stability")})
    out["runs"] = runs
    return out

# ---------------------------------------------------------------- phase 19
def gr_cli(torch, kernels, label, deck, extra=(), text=None):
    """One deck of phase 19 through ``main.cli`` in a temporary directory
    (``text`` written there as the deck when given), the launch counts
    set to 0 just before: returns (launches, mesh, phys, driver, state,
    files, peak), ``files`` the text of every ``.hst`` and ``.dat`` file
    written and ``peak`` the run's ``torch.cuda.max_memory_allocated``.
    Raises if any kernel launched."""
    from athenak_tpu_torch import main as cli_main
    os.environ["ATHENAK_DEVICE"] = "cuda"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        if text is not None:
            deck = os.path.join(tmp, "deck.athinput")
            with open(deck, "w") as f:
                f.write(text)
        run = os.path.join(tmp, "run")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        try:
            mesh, phys, driver, state = cli_main.cli(
                ["-i", deck, "-d", run, *extra])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels.ALL}
        peak = torch.cuda.max_memory_allocated()
        files = {}
        for f in sorted(os.listdir(run)):
            if f.endswith((".hst", ".dat")):
                with open(os.path.join(run, f)) as fh:
                    files[f] = fh.read()
    if any(launches.values()):
        raise AssertionError(f"phase 19 {label}: kernels launched: "
                             f"{launches}")
    return launches, mesh, phys, driver, state, files, peak


def gr_check(torch, mesh, phys, state, label):
    """Finite u and w and, under MHD, div(B) at roundoff: max|div B| dx /
    max|B| over the interior <= 1e-11 in float64, 1e-5 in float32.
    Returns (that measure, max|div B|), None without a field."""
    for k in ("u", "w"):
        if not bool(torch.isfinite(state[k]).all()):
            raise AssertionError(f"phase 19 {label}: non-finite {k}")
    if "bfc" not in state:
        return None
    b = state["bfc"]
    if not all(bool(torch.isfinite(v).all()) for v in b.values()):
        raise AssertionError(f"phase 19 {label}: non-finite face field")
    ng = mesh.mb_indcs.ng
    div = ((b["x1f"][..., 1:] - b["x1f"][..., :-1]) / phys.dxs["x1"]
           + (b["x2f"][..., 1:, :] - b["x2f"][..., :-1, :]) / phys.dxs["x2"]
           + (b["x3f"][:, 1:] - b["x3f"][:, :-1]) / phys.dxs["x3"])
    dmax = float(interior(div, ng).abs().max())
    bmax = max(max(float(v.abs().max()) for v in b.values()), 1e-30)
    rel = dmax * phys.dxs["x1"] / bmax
    lim = 1e-11 if state["u"].dtype == torch.float64 else 1e-5
    if rel > lim:
        raise AssertionError(f"phase 19 {label}: max|div B| dx / max|B| = "
                             f"{rel:g} > {lim:g}")
    return rel, dmax


def hst_table(text):
    """(labels, rows) of a history file's text."""
    lines = text.splitlines()
    labels = re.findall(r"\[\d+\]=(\S+)", lines[1])
    rows = [[float(x) for x in ln.split()] for ln in lines[2:]]
    return labels, rows


def gr_rate(torch, mesh, driver, state, ncyc):
    """zone-cycles/s of ncyc more cycles of a warm run (CUDA events)."""
    cycle = driver.make_cycle_fn()
    dt = mesh.dt
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(ncyc):
        state, dtnew, _ = cycle(state, dt)
        dt = min(2.0 * dt, driver.cfl_no * float(dtnew))
    t1.record()
    torch.cuda.synchronize()
    mbi = mesh.mb_indcs
    return (ncyc * mesh.nmb_total * mbi.nx1 * mbi.nx2 * mbi.nx3
            / (t0.elapsed_time(t1) / 1e3))


def gr_stage_parts(torch, phys, state, mesh):
    """ms a call of each part of a GR MHD stage on the run's state (CUDA
    events), and the device launches of one whole stage
    (``torch.profiler``; None where it records no device time)."""
    from athenak_tpu_torch.ops.eos_gr import coord_src_terms
    u, w, bcc, bfc = state["u"], state["w"], state["bcc"], state["bfc"]
    bdt = 0.5 * mesh.dt
    saved = phys.save_state(state)
    flx, emf = phys.fluxes(w, bcc, bfc)
    fden = {n: f[:, 0] for n, f in flx.items()}

    def fill():
        phys.bvals.fill_ghosts(u.clone())
        phys.fill_ghosts_fc({k: v.clone() for k, v in bfc.items()})

    parts = {
        "c2p": cuda_ms(lambda: phys.cons_to_prim(u, bcc), 3),
        "fluxes": cuda_ms(lambda: phys.fluxes(w, bcc, bfc), 3),
        "fofc": cuda_ms(lambda: phys._apply_fofc(
            u, u, w, bcc, bfc, flx, emf, 0.5, 0.5, bdt), 3),
        "rk_update": cuda_ms(lambda: phys.rk_update(u, u, flx, 0.5, 0.5,
                                                    bdt), 3),
        "coord_src": cuda_ms(lambda: coord_src_terms(
            u.clone(), w, phys.eos, phys.geom, bdt, bcc=bcc), 3),
        "corner_e_ct": cuda_ms(lambda: phys.ct_update(
            bfc, bfc, *phys.corner_e(w, bcc, fden, emf), 0.5, 0.5, bdt), 3),
        "fill": cuda_ms(fill, 3),
        "stage": cuda_ms(lambda: phys.stage_update(state, saved, 0.5, 0.5,
                                                   bdt), 3),
    }
    split = device_split(torch, lambda: phys.stage_update(
        state, saved, 0.5, 0.5, bdt), 1)
    return parts, split_launches(split, 1)


def gr_torus(torch, kernels, label, deck, text=None, parts=False):
    """A torus deck for NCYC_GR cycles with a history row a cycle: the
    checks of phase 19 (see the module docstring); with ``parts`` the
    zone-cycles/s of 5 more cycles, the stage's parts and launches."""
    launches, mesh, phys, driver, state, files, peak = gr_cli(
        torch, kernels, label, deck, [f"time/nlim={NCYC_GR}", *GR_ROWS],
        text=text)
    divb = gr_check(torch, mesh, phys, state, label)
    hst, = [v for k, v in files.items() if k.endswith(".hst")]
    labels, rows = hst_table(hst)
    flux_cols = [i for i, lab in enumerate(labels)
                 if lab.startswith(("mdot", "edot", "ldot", "phi"))]
    if len(rows) != NCYC_GR + 2 or not flux_cols or not all(
            math.isfinite(r[i]) for r in rows for i in flux_cols):
        raise AssertionError(f"phase 19 {label}: history rows {len(rows)}, "
                             f"flux columns {flux_cols} not all finite")
    out = {"launches": launches, "div_b": divb,
           "counters": dict(driver.ecounters), "peak_gb": peak / 2 ** 30,
           "metric_gb": phys.geom.nbytes() / 2 ** 30,
           "wall_zcps": driver.zcps,
           "flux_row": {labels[i]: rows[-1][i] for i in flux_cols}}
    if parts:
        out["zcps"] = gr_rate(torch, mesh, driver, state, 5)
        out["parts_ms"], out["launches_a_stage"] = gr_stage_parts(
            torch, phys, state, mesh)
    print(f"phase 19: {label} {NCYC_GR} cycles, no kernel launched; "
          f"div B {divb}; counters {out['counters']}; peak "
          f"{out['peak_gb']:.2f} GB (metric {out['metric_gb']:.2f}); wall "
          f"{driver.zcps:.3e} zc/s; flux columns {out['flux_row']}"
          + (f"; {out['zcps']:.3e} zc/s over 5 more cycles; stage parts "
             f"ms {out['parts_ms']}; device launches a stage "
             f"{out['launches_a_stage']}" if parts else ""))
    return out


def gr_bars(torch, kernels):
    """The Bondi and monopole decks of the JAX package's tests, f64, held
    to those tests' bars."""
    out = {}
    for label, n, tlim, phys_, bar in (("bondi", 32, 3.0, "hydro", 5e-3),
                                       ("bondi_mhd", 24, 2.0, "mhd", 1e-2)):
        launches, mesh, phys, driver, state, files, _ = gr_cli(
            torch, kernels, label, None,
            text=GR_BONDI_DECK.format(n=n, tlim=tlim, phys=phys_))
        gr_check(torch, mesh, phys, state, label)
        rms = float(files["gr_bondi-errs.dat"].splitlines()[-1].split()[4])
        if not rms < bar:
            raise AssertionError(f"phase 19 {label}: RMS-L1 {rms} >= {bar}")
        out[label] = {"launches": launches, "rms_l1": rms,
                      "ncycle": mesh.ncycle, "wall_zcps": driver.zcps}
        print(f"phase 19: {label} {n}^3 f64 to t = {tlim}: RMS-L1 {rms:.4e} "
              f"(bar {bar}), {mesh.ncycle} cycles, no kernel launched")
    launches, mesh, phys, driver, state, files, _ = gr_cli(
        torch, kernels, "monopole", None, text=GR_MONO_TEST_DECK)
    divb = gr_check(torch, mesh, phys, state, "monopole")
    omega = [float(r.split()[2])
             for r in files["monopole-diag.dat"].splitlines()[1:]]
    mean = sum(omega) / len(omega)
    std = math.sqrt(sum((o - mean) ** 2 for o in omega) / len(omega))
    err = abs(mean - 0.5) / 0.5
    if not (len(omega) > 100 and err < 0.2 and std < 0.12
            and divb[1] < 1e-11):
        raise AssertionError(f"phase 19 monopole: rows {len(omega)}, "
                             f"mean error {err}, std {std}, div B {divb}")
    out["monopole"] = {"launches": launches, "rows": len(omega),
                       "mean_err": err, "std": std, "div_b": divb,
                       "ncycle": mesh.ncycle, "wall_zcps": driver.zcps}
    print(f"phase 19: monopole 32x32x16 f64 to t = 4 ({mesh.ncycle} "
          f"cycles): |<Omega>/Omega_H - 0.5|/0.5 = {err:.4f}, std "
          f"{std:.4f}, {len(omega)} rows, max|div B| {divb[1]:.3e}, no "
          "kernel launched")
    return out


def gr_big_monopole(torch, kernels):
    """``gr_monopole.athinput`` as shipped, 2 cycles (f64)."""
    launches, mesh, phys, driver, state, _, peak = gr_cli(
        torch, kernels, "gr_monopole", GR_MONOPOLE, ["time/nlim=2"])
    divb = gr_check(torch, mesh, phys, state, "gr_monopole")
    cycle = driver.make_cycle_fn()
    ms = host_ms(torch, lambda: cycle(state, mesh.dt), 1)
    out = {"launches": launches, "div_b": divb, "cycle_ms": ms,
           "peak_gb": peak / 2 ** 30,
           "metric_gb": phys.geom.nbytes() / 2 ** 30,
           "cells": mesh.nmb_total * mesh.mb_indcs.ncells1
           * mesh.mb_indcs.ncells2 * mesh.mb_indcs.ncells3}
    print(f"phase 19: gr_monopole 256x256x128 f64 2 cycles: {ms:.1f} ms a "
          f"cycle, peak {out['peak_gb']:.2f} GB (metric "
          f"{out['metric_gb']:.2f} GB, {out['cells']} cells with ghosts), "
          f"div B {divb}, no kernel launched")
    return out


def gr_shipped(torch, kernels):
    """The other GR decks of ``inputs/`` as shipped (f64), 5 cycles each
    through the CLI: no kernel, finite, div(B) at roundoff."""
    out = {}
    for label, (folder, name) in GR_SHIPPED.items():
        launches, mesh, phys, driver, state, _, _ = gr_cli(
            torch, kernels, label, os.path.join(ROOT, "inputs", folder, name),
            ["time/nlim=5"])
        divb = gr_check(torch, mesh, phys, state, label)
        out[label] = {"launches": launches, "div_b": divb,
                      "wall_zcps": driver.zcps}
        print(f"phase 19: inputs/{folder}/{name} as shipped, 5 cycles: "
              f"{driver.zcps:.3e} zc/s wall, div B {divb}, no kernel "
              "launched")
    return out


def gr_card_cpu(torch):
    """Bondi at 16^3, f64, 3 cycles on the card and on the CPU: u within
    1e-10 of its scale."""
    from athenak_tpu_torch import main as run_main
    from athenak_tpu_torch.athinput import ParameterInput
    text = GR_BONDI_DECK.format(n=16, tlim=3.0, phys="hydro")
    u = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for dev in ("cuda", "cpu"):
                pin = ParameterInput.from_string(text)
                pin.modify_from_cmdline(["time/nlim=3"])
                u[dev] = run_main.run(pin, device=dev)[3]["u"].cpu()
        finally:
            os.chdir(cwd)
    ref = interior(u["cpu"])
    err = float((interior(u["cuda"]) - ref).abs().max() / ref.abs().max())
    if err > 1e-10:
        raise AssertionError(f"phase 19: Bondi card against CPU {err:g}")
    print(f"phase 19: Bondi 16^3 f64 3 cycles, the card against the CPU: "
          f"{err:.3e} of u's scale")
    return err


def gr_disk(torch, kernels):
    """``disk_magnetosphere.athinput`` as shipped, 10 cycles (f64)."""
    launches, mesh, phys, driver, state, files, _ = gr_cli(
        torch, kernels, "disk_magnetosphere", DISK_MAG,
        [f"time/nlim={NCYC_GR}"])
    divb = gr_check(torch, mesh, phys, state, "disk_magnetosphere")
    labels, rows = hst_table(files["diskmag.hst"])
    planet = [lab for lab in labels if lab.endswith("0") and lab[:-1] in (
        "fr", "ft", "fp", "fxpp", "fypp", "fzpp", "torque", "xpp", "ypp",
        "zpp", "rpp", "tpp", "ppp", "mp")]
    if len(planet) != 14 or len(rows) != 2 or not all(
            math.isfinite(v) for r in rows for v in r):
        raise AssertionError(f"phase 19 disk_magnetosphere: planet columns "
                             f"{planet}, rows {rows}")
    out = {"launches": launches, "div_b": divb, "t": float(state["t"]),
           "counters": dict(driver.ecounters), "wall_zcps": driver.zcps,
           "mp0": rows[-1][labels.index("mp0")]}
    print(f"phase 19: disk_magnetosphere 8 x 32x32x16 f64 {NCYC_GR} "
          f"cycles: div B {divb}, t {out['t']:.6e}, planet mass "
          f"{out['mp0']:.6e}, counters {out['counters']}, no kernel "
          "launched")
    return out


def gr_restart(torch, kernels):
    """-r restarts: the torus at TORUS_RST and the 32^3 Bondi (f64), 10
    cycles straight against 5 + -r 5, every state entry and the history
    rows after the restart point bitwise equal."""
    from athenak_tpu_torch import main as cli_main
    from athenak_tpu_torch.outputs import load_restart
    os.environ["ATHENAK_DEVICE"] = "cuda"
    n = NCYC_GR // 2
    out = {}
    cwd = os.getcwd()
    for label, text, base, extra in (
            ("torus", GR_TORUS_DECK, "bench_torus", TORUS_RST),
            ("bondi", GR_BONDI_DECK.format(n=32, tlim=3.0, phys="hydro"),
             "gr_bondi", [])):
        common = [*extra, *GR_ROWS, "output9/file_type=rst",
                  f"output9/dcycle={n}"]
        with tempfile.TemporaryDirectory() as tmp:
            deck = os.path.join(tmp, "deck.athinput")
            with open(deck, "w") as f:
                f.write(text)
            try:
                kernels.reset_counts()
                *_, s1 = cli_main.cli(["-i", deck, "-d", os.path.join(
                    tmp, "straight"), *common, f"time/nlim={2 * n}"])
                os.chdir(cwd)
                cli_main.cli(["-i", deck, "-d", os.path.join(tmp, "first"),
                              *common, f"time/nlim={n}"])
                os.chdir(cwd)
                rst = os.path.join(tmp, "first", f"{base}.00001.rst")
                t_rst = load_restart(rst)[1]
                mesh, phys, _, s2 = cli_main.cli([
                    "-r", rst, "-d", os.path.join(tmp, "first"),
                    f"time/nlim={2 * n}"])
            finally:
                os.chdir(cwd)
            launched = {k.name: k.launches for k in kernels.ALL
                        if k.launches}
            rows = []
            for run in ("straight", "first"):
                with open(os.path.join(tmp, run, f"{base}.hst")) as f:
                    rows.append([r for r in f.read().splitlines()[2:]
                                 if float(r.split()[0]) > t_rst])
        keys = sorted(k for k in s1 if k != "bfc") + [
            f"bfc/{c}" for c in s1.get("bfc", {})]
        for key in keys:
            a = s1[key] if "/" not in key else s1["bfc"][key[4:]]
            b = s2[key] if "/" not in key else s2["bfc"][key[4:]]
            if not torch.equal(a, b):
                raise AssertionError(f"phase 19 restart {label}: {key} not "
                                     "bitwise equal to the straight run")
        if launched or mesh.ncycle != 2 * n or len(rows[0]) != n + 1 \
                or rows[0] != rows[1]:
            raise AssertionError(f"phase 19 restart {label}: launches "
                                 f"{launched}, {mesh.ncycle} cycles, rows "
                                 f"{len(rows[0])} / {len(rows[1])}")
        if label == "bondi" and phys.bvals.user_bc_func is None:
            raise AssertionError("phase 19 restart bondi: no user boundary")
        out[label] = {"keys": keys, "rows": len(rows[0])}
        print(f"phase 19: restart {label}: {2 * n} cycles straight and {n} "
              f"+ -r {n} bitwise equal in {keys}; {len(rows[0])} history "
              f"rows after t = {t_rst:.6e} equal; no kernel launched")
    return out


def phase_gr(torch, kernels, card):
    """Phase 19 (see the module docstring); the JAX tests' bars and the
    restarts run in a lane."""
    out = {"torus124": gr_torus(torch, kernels, "torus124", None,
                                text=GR_TORUS_DECK, parts=True),
           "torus_sane": gr_torus(torch, kernels, "torus_sane",
                                  TORUS_SANE)}
    out.update(gr_shipped(torch, kernels))
    out["gr_monopole"] = gr_big_monopole(torch, kernels)
    out["card_cpu"] = gr_card_cpu(torch)
    out["disk_magnetosphere"] = gr_disk(torch, kernels)
    out["runs"] = {k: out[k] for k in ("torus124", "torus_sane",
                                       "gr_monopole", "disk_magnetosphere",
                                       *GR_SHIPPED)}
    return out


# ---------------------------------------------------------------------------
# phase 20: diffusion and self-gravity
# ---------------------------------------------------------------------------
NCYC_GRAV = 10
NCYC_BE = 20
DIFF_FULL = ["mhd/nu_iso=1e-3", "mhd/eta_ohm=1e-3", "mhd/alpha_iso=1e-3"]
DIFF_NOETA = ["mhd/nu_iso=1e-3", "mhd/alpha_iso=1e-3"]
VISC_DECK = os.path.join(ROOT, "inputs", "hydro", "viscosity.athinput")
RESIST_DECK = os.path.join(ROOT, "inputs", "mhd", "resistivity.athinput")
SHOCK_CLOUD = os.path.join(ROOT, "inputs", "hydro", "shock_cloud.athinput")
JEANS = os.path.join(ROOT, "inputs", "tests", "jeans_wave.athinput")
SELFGRAV = os.path.join(ROOT, "inputs", "tests", "selfgravity.athinput")
BINARY = os.path.join(ROOT, "inputs", "tests", "binary_gravity.athinput")
BE = os.path.join(ROOT, "inputs", "tests", "be_collapse.athinput")
BE_MHD = os.path.join(ROOT, "inputs", "tests", "be_collapse_mhd.athinput")
JEANS_BIG = ["job/precision=single", "mesh/nx1=256", "mesh/nx2=128",
             "mesh/nx3=128"]
# in float64: the generator's floor density (1e-300) is 1e-38 in
# float32, and the float32 state goes non-finite within two cycles on
# either path, so kernel B (float32) has no run here; the deck's tlim
# (0.5) falls within 10 cycles at 128^3
SELFGRAV_BIG = ["mesh/nx1=128", "mesh/nx2=128", "mesh/nx3=128",
                "time/tlim=100"]
# kernel G's gate takes two ghost cells (as the JAX package's): the
# shipped deck's four close it, so G runs on this variant
BE_G = ["job/precision=single", "mesh/nghost=2"]
# tests/test_jeans.py's deck (copied here as text): the shipped
# jeans_wave.athinput sets njeans, a key the generator does not read
JEANS_TEST_DECK = """
<job>
basename = JeansWave
<mesh>
nghost = 2
nx1 = 32
x1min = 0.0
x1max = 1.0
ix1_bc = periodic
ox1_bc = periodic
nx2 = 16
x2min = 0.0
x2max = 0.5
ix2_bc = periodic
ox2_bc = periodic
nx3 = 16
x3min = 0.0
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic
<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = -1
tlim = 0.1
ndiag = 100000
<hydro>
eos = isothermal
reconstruct = plm
rsolver = hlle
iso_sound_speed = 1.0
<gravity>
four_pi_G = 1.0
<hydro_srcterms>
self_gravity = true
<problem>
pgen_name = gravity
amp = 1.0e-6
n_jeans = 0.5
"""


def turn_rates(torch, deck, extra, block):
    """zone-cycles/s of the kernel and the plain path in turns (true,
    false, true, false), each over NCYC_GRAV cycles after a warm-up
    cycle (CUDA events; ``timed_cycles``)."""
    rates = {"true": [], "false": []}
    for use in ("true", "false", "true", "false"):
        rates[use].append(timed_cycles(torch, use, deck, NCYC_GRAV,
                                       list(extra), block))
    return rates


def grav_cli(torch, kernels, deck, extra=(), ncyc=None):
    """``main.cli`` on ``deck`` in a temporary directory (``ncyc`` cycles,
    or to tlim), the launch counts set to 0 just before and read just
    after: (launches of the kernels that launched, mesh, phys, driver,
    state, the names of the files written)."""
    from athenak_tpu_torch import main as cli_main
    os.environ["ATHENAK_DEVICE"] = "cuda"
    cwd = os.getcwd()
    extra = list(extra) + ([f"time/nlim={ncyc}"] if ncyc else [])
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_counts()
        try:
            mesh, phys, driver, state = cli_main.cli(
                ["-i", deck, "-d", tmp, *extra])
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels.ALL if k.launches}
        files = sorted(os.listdir(tmp))
    if ncyc and mesh.ncycle != ncyc:
        raise AssertionError(f"{deck}: {mesh.ncycle} cycles, {ncyc} asked")
    if not bool(torch.isfinite(state["u"]).all()):
        raise AssertionError(f"{deck} {extra}: non-finite state")
    return launches, mesh, phys, driver, state, files


def expect_launches(label, got, expect, phase="20"):
    if got != expect:
        raise AssertionError(f"phase {phase} {label}: launches {got}, "
                             f"expected {expect}")


def bitwise_paths(torch, label, a, b):
    """The kernel and plain paths of a deck whose only kernels are the
    fills: every entry of the two states bitwise equal."""
    for key in ("u", "w", "phi"):
        if key in a and not torch.equal(a[key], b[key]):
            raise AssertionError(f"phase 20 {label}: {key} differs between "
                                 "the kernel and the plain path")


def grav_solve_ms(torch, phys, state):
    """The run's mean V-cycles a solve (the multigrid; None for the
    FFT), then ms (events) and V-cycles of a solve from the state
    started from zeros or the full-multigrid guess, as the deck asks:
    (run_vcycles, ms, vcycles)."""
    pg = phys.pgrav
    run = pg.ncycles / max(pg.nsolve, 1) if hasattr(pg, "ncycles") \
        else None
    n0, c0 = pg.nsolve, getattr(pg, "ncycles", 0)
    ms = cuda_ms(lambda: pg.solve(state["u"], phys.bvals), 5)
    cyc = (getattr(pg, "ncycles", 0) - c0) / max(pg.nsolve - n0, 1)
    return run, ms, cyc


def amplitude(x, y):
    """The least-squares amplitude of sin(2 pi x) in y."""
    import numpy as np
    s = np.sin(2.0 * math.pi * x)
    return abs(float(np.dot(y, s) / np.dot(s, s)))


def diff_blast(torch, kernels, card):
    """The 124^3 blast with viscosity, Ohmic resistivity and conduction:
    J three times a stage, B at every fill, A and D never (exact); the
    plain path within SMR_PATH_TOL's tiers of what it changed; the same
    without resistivity: J and D (once a stage).  J against its plain
    version on the diffusive state (f32 two-tier); the ms of a stage's
    parts and the dt limits."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import flux
    n = NCYC_GRAV
    out, states = {}, {}
    for label, extra in (("diff_blast", DIFF_FULL),
                         ("diff_blast plain", DIFF_FULL
                          + ["mhd/use_kernels=false"]),
                         ("diff_blast noeta", DIFF_NOETA)):
        got, mesh, phys, driver, state, files = grav_cli(
            torch, kernels, DECK, extra, n)
        expect = {} if "plain" in label else {
            "fused_flux_dir": 6 * n, "periodic_fill_cc": 1 + 2 * n,
            "periodic_fill_fc": 1 + 2 * n}
        if label == "diff_blast noeta":
            expect["fused_ct3d"] = 2 * n
        expect_launches(label, got, expect)
        if phys.presist is not None and (phys.use_fused_ct
                                         or phys.use_mega_v2):
            raise AssertionError(f"{label}: A or D open with resistivity")
        out[label] = {"launches": got, "zcps": driver.zcps}
        states[label] = (mesh, phys, state)
        print(f"phase 20: {label} (124^3, f32): {n} cycles, launches {got}; "
              f"[{card}] CLI zone-cycles/s {driver.zcps:.6e} (wall clock)")
    state0 = build(pin_for(DIFF_FULL), device="cuda")[-1]
    ka, pa = states["diff_blast"][2], states["diff_blast plain"][2]
    diff = {k: change_diff(a, b, c) for k, a, b, c in
            [("u", ka["u"], pa["u"], state0["u"])]
            + [(c, ka["bfc"][c], pa["bfc"][c], state0["bfc"][c])
               for c in ("x1f", "x2f", "x3f")]}
    for k, d in diff.items():
        if not (d[0] > 0.95 and d[1] < SMR_PATH_TOL[1]):
            raise AssertionError(f"diff_blast: paths apart in {k}: {d}")
    del state0, pa
    mesh, phys, state = states["diff_blast"]
    w, bcc, bfc = state["w"], state["bcc"], state["bfc"]
    err = 0.0
    for name, _axis, ivx, _dx in phys.dirs:
        args = (w, bcc, bfc[f"{name}f"], phys.eos, name, ivx)
        for g, r in zip(flux.fused_flux_dir(*args),
                        flux.flux_dir_plain(*args)):
            g, r = faces(g), faces(r)
            err = max(err, two_tier(g, r, float(r.abs().max()) or 1.0,
                                    f"diff_blast fused_flux_dir {name}"))
    from athenak_tpu_torch.physics.mhd import corner_e
    flx, emf = phys.fluxes(w, bcc, bfc)
    dirs, nd = phys.dirs, len(phys.dirs)
    fden = {k: f[:, 0] for k, f in flx.items()}
    e123 = corner_e(w, bcc, fden, emf, nd)
    parts = {
        "fused_flux_dir x3": sum(cuda_ms(lambda d=d: flux.fused_flux_dir(
            w, bcc, bfc[f"{d[0]}f"], phys.eos, d[0], d[2]), 10)
            for d in dirs),
        "viscous flux": cuda_ms(lambda: phys.pvisc.add_viscous_flux(
            w, flx, dirs), 10),
        "heat flux": cuda_ms(lambda: phys.pcond.add_heat_flux(
            w, flx, dirs), 10),
        "resistive flux": cuda_ms(lambda: phys.presist.add_resistive_flux(
            bfc, bcc, flx, dirs, nd), 10),
        "resistive EMF": cuda_ms(lambda: phys.presist.add_resistive_emf(
            bfc, bcc, *e123, nd), 10),
        "corner EMF": cuda_ms(lambda: corner_e(w, bcc, fden, emf, nd), 10)}
    dts = {"cfl": float(phys.new_dt(w, bcc)),
           "viscous": float(phys.pvisc.new_dt(nd, w)),
           "conduction": float(phys.pcond.new_dt(nd, w)),
           "resistive": float(phys.presist.new_dt(bcc, nd, w))}
    rates = turn_rates(torch, DECK, DIFF_FULL, "mhd")
    print(f"phase 20: [{card}] diff_blast zone-cycles/s in turns (events, "
          f"after a warm-up cycle) {rates}")
    print(f"phase 20: diff_blast kernel vs plain path {diff}; "
          f"fused_flux_dir agrees with its plain version on the diffusive "
          f"state (f32 two-tier, max abs {err:.3e}); [{card}] ms of a "
          f"stage's parts {parts}; dt limits (before the CFL number) {dts}")
    return {"runs": out, "path_diff": diff, "parts_ms": parts, "dt": dts,
            "flux_dir_err": err, "rates": rates}


def diffusion_bars(torch, kernels, card):
    """The shipped 1-D decks to tlim in float64: the decay of the shear
    and field amplitudes within 5% of exp(-coef k^2 t) (the bars of
    tests/test_diffusion.py)."""
    out = {}
    for label, deck, coef, getter in (
            ("viscosity", VISC_DECK, 0.02, lambda s: s["w"][0, 2]),
            ("resistivity", RESIST_DECK, 0.02, lambda s: s["bcc"][0, 1])):
        got, mesh, phys, driver, state, _ = grav_cli(torch, kernels, deck)
        expect_launches(label, got, {})
        mbi = mesh.mb_indcs
        act = slice(mbi.is_, mbi.ie + 1)
        y = getter(state)[0, 0, act].double().cpu().numpy()
        x = mesh.cell_centers(0)[0][act]
        amp = amplitude(x, y)
        want = 1.0e-6 * math.exp(-coef * (2 * math.pi) ** 2 * mesh.time)
        rel = abs(amp - want) / want
        if rel > 0.05:
            raise AssertionError(f"{label}: amplitude {amp:g} against "
                                 f"{want:g}")
        out[label] = {"cycles": mesh.ncycle, "amp": amp, "expect": want,
                      "rel_err": rel, "zcps": driver.zcps}
        print(f"phase 20: {label} as shipped (64 cells, f64) to t = "
              f"{mesh.time:g} in {mesh.ncycle} cycles: amplitude {amp:.6e}, "
              f"exp(-coef k^2 t) {want:.6e}, {rel:.3e} apart (bar 0.05); "
              f"[{card}] zone-cycles/s {driver.zcps:.6e}")
    got, mesh, phys, driver, state, _ = grav_cli(torch, kernels,
                                                 SHOCK_CLOUD, ncyc=NCYC_GRAV)
    expect_launches("shock_cloud", got, {})
    out["shock_cloud"] = {"zcps": driver.zcps, "launches": got}
    print(f"phase 20: shock_cloud as shipped (160x80x80, f64, inflow): "
          f"{NCYC_GRAV} cycles, no kernel; [{card}] zone-cycles/s "
          f"{driver.zcps:.6e}")
    return out


def fill_runs(torch, kernels, card, label, deck, big, fill_key, extra_b):
    """A gravity deck on one periodic block: as shipped (f64, no kernel),
    then at the big size on the kernel path (in f32 B on u and phi: once
    at the start, twice a stage, ``extra_b`` more) and the plain path,
    bitwise equal, and their rates in turns; ms and V-cycles of a solve.
    With ``fill_key`` None the big size runs in f64, where no kernel can
    launch and the two paths are one: once."""
    out = {}
    got, mesh, phys, driver, state, _ = grav_cli(torch, kernels, deck,
                                                 ncyc=NCYC_GRAV)
    expect_launches(label, got, {})
    run, ms, cyc = grav_solve_ms(torch, phys, state)
    out["shipped"] = {"zcps": driver.zcps, "solve_ms": ms, "vcycles": cyc,
                      "run_vcycles": run}
    print(f"phase 20: {label} as shipped (f64): {NCYC_GRAV} cycles, "
          f"V-cycles a solve in the run {run}; [{card}] zone-cycles/s "
          f"{driver.zcps:.6e}, a solve from the start guess {ms:.3f} ms "
          f"({cyc:g} V-cycles)")
    res = {}
    for use in ("true", "false") if fill_key else ("true",):
        got, mesh, phys, driver, state, _ = grav_cli(
            torch, kernels, deck, big + [f"hydro/use_kernels={use}"],
            NCYC_GRAV)
        expect_launches(f"{label} big {use}", got, {
            fill_key: 1 + 4 * NCYC_GRAV + extra_b}
            if use == "true" and fill_key else {})
        run, ms, cyc = grav_solve_ms(torch, phys, state)
        res[use] = state
        out[use] = {"launches": got, "zcps": driver.zcps, "solve_ms": ms,
                    "vcycles": cyc, "run_vcycles": run}
        print(f"phase 20: {label} {big} use_kernels={use}: launches {got}, "
              f"V-cycles a solve in the run {run}; [{card}] zone-cycles/s "
              f"{driver.zcps:.6e}, a solve from the start guess {ms:.3f} ms "
              f"({cyc:g} V-cycles)")
    if fill_key:
        bitwise_paths(torch, label, res["true"], res["false"])
        out["rates"] = turn_rates(torch, deck, big, "hydro")
        print(f"phase 20: [{card}] {label} {big} zone-cycles/s in turns "
              f"(events, after a warm-up cycle) {out['rates']}")
    return out


def jeans_bars(torch, kernels, card):
    """tests/test_jeans.py's stable case on the card in f64: the
    oscillation frequency at 64 x 32 x 32 within 1% of the analytic one
    and the error at least 1/0.35 times smaller than at 32 x 16 x 16;
    and the shipped deck to tlim in f64."""
    from athenak_tpu_torch.pgen import jeans_wave
    got, mesh, phys, driver, state, _ = grav_cli(torch, kernels, JEANS)
    expect_launches("jeans shipped", got, {})
    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        deck = os.path.join(tmp, "jeans.athinput")
        with open(deck, "w") as f:
            f.write(JEANS_TEST_DECK)
        for res in (32, 64):
            got, mesh, phys, driver, state, _ = grav_cli(
                torch, kernels, deck, [f"mesh/nx1={res}",
                                       f"mesh/nx2={res // 2}",
                                       f"mesh/nx3={res // 2}"])
            r = jeans_wave.final(None, mesh, phys, state)
            errs[res] = abs(r["omega_measured"] - r["omega"]) / r["omega"]
    if not (errs[64] < 0.01 and errs[64] / errs[32] < 0.35):
        raise AssertionError(f"jeans: omega errors {errs}")
    print(f"phase 20: jeans_wave as shipped (64x32x32, f64) to t = 1 "
          f"finite; tests/test_jeans.py's stable deck (n_jeans 0.5, f64): "
          f"omega errors {errs} (bars: < 0.01 at 64, ratio < 0.35)")
    return {"omega_err": errs}


def binary_bars(torch, card):
    """binary_gravity as shipped (f64, 64^3 root, two refined levels): the
    verbose solve of the initial state reaches 1e-9 in at most 13
    V-cycles and its acceleration L2 error is below 1 (the bars of
    tests/test_multigrid.py::test_binary_gravity_smr), then one cycle
    through the CLI and the final report."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.pgen import binary_gravity
    pin = pin_for([], BINARY)
    mesh, phys, _, _, state = build(pin, device="cuda")
    t0 = time.perf_counter()
    hist = phys.pgrav.solve_verbose(state["u"])
    torch.cuda.synchronize()
    verbose_ms = 1e3 * (time.perf_counter() - t0)
    res = binary_gravity.final(pin, mesh, phys, state,
                               phi=phys.pgrav._last_phi)
    if not (hist[-1] <= 1e-9 and len(hist) - 1 <= 13
            and math.isfinite(res["acc_l2"]) and res["acc_l2"] < 1.0):
        raise AssertionError(f"binary_gravity: defects {hist}, {res}")
    _, ms, cyc = grav_solve_ms(torch, phys, state)
    print(f"phase 20: binary_gravity as shipped ({mesh.nmb_total} blocks on "
          f"levels {sorted(set(mesh.mb_lev.tolist()))}, f64): defect "
          f"{hist[-1]:.3e} after {len(hist) - 1} V-cycles (bars 1e-9, 13), "
          f"acceleration L2 {res['acc_l2']:.4e} (bar 1), potential L2 "
          f"{res['pot_l2']:.4e}; [{card}] the verbose solve {verbose_ms:.1f} "
          f"ms (host clock, a host read a cycle), a solve {ms:.2f} ms "
          f"({cyc:g} V-cycles)")
    return {"defects": hist, "errors": res, "verbose_ms": verbose_ms,
            "solve_ms": ms, "vcycles": cyc}


def be_runs(torch, kernels, card):
    """be_collapse as shipped (f64, 20 cycles: a tree update, the solves on
    every tree) and with two ghost cells in f32 on both paths (G on u and
    phi while the tree is flat, exact; the paths bitwise equal);
    be_collapse_mhd as shipped (f64, 10 cycles, its bin and rst outputs)
    and in f32 on both paths (J three times a stage; the paths within
    SMR_PATH_TOL's tiers of the plain path's range), J against its plain
    version on its state; a -r restart of be_collapse_mhd (10 cycles
    straight against 5 + 5, bitwise)."""
    out = {}
    got, mesh, phys, driver, state, _ = grav_cli(torch, kernels, BE,
                                                 ncyc=NCYC_BE)
    expect_launches("be_collapse", got, {})
    trees = [(r["ncycle"], r["nmb"]) for r in driver.pamr.updates]
    if not trees:
        raise AssertionError("be_collapse: no tree update")
    run, ms, cyc = grav_solve_ms(torch, phys, state)
    out["be_collapse"] = {"zcps": driver.zcps, "trees": trees,
                          "solve_ms": ms, "vcycles": cyc,
                          "run_vcycles_last_tree": run}
    print(f"phase 20: be_collapse as shipped (f64): {NCYC_BE} cycles, trees "
          f"(cycle, blocks) {trees}, V-cycles a solve on the last tree "
          f"{run}; [{card}] zone-cycles/s {driver.zcps:.6e} (wall clock, "
          f"AMR included), a solve on the last tree from the start guess "
          f"{ms:.2f} ms ({cyc:g} V-cycles)")
    res = {}
    for use in ("true", "false"):
        got, mesh, phys, driver, state, _ = grav_cli(
            torch, kernels, BE, BE_G + [f"hydro/use_kernels={use}"], NCYC_BE)
        trees = [(r["ncycle"], r["leaves"]) for r in driver.pamr.updates]
        flat = flat_cycles(trees, NCYC_BE)
        expect_launches(f"be_collapse G {use}", got, {
            "pool_fill": 1 + 4 * flat} if use == "true" else {})
        res[use] = (state, trees)
        out[f"be_collapse G {use}"] = {"launches": got, "zcps": driver.zcps,
                                      "flat_cycles": flat}
        print(f"phase 20: be_collapse {BE_G} use_kernels={use}: launches "
              f"{got} ({flat} cycles on the flat tree); [{card}] zone-cycles"
              f"/s {driver.zcps:.6e}")
    if res["true"][1] != res["false"][1]:
        raise AssertionError("be_collapse G: the paths took other trees")
    bitwise_paths(torch, "be_collapse G", res["true"][0], res["false"][0])
    del res
    got, mesh, phys, driver, state, files = grav_cli(torch, kernels, BE_MHD,
                                                     ncyc=NCYC_GRAV)
    expect_launches("be_collapse_mhd", got, {})
    for want in ("mhd_w", "mhd_bcc", "grav_phi"):
        if not any(f".{want}." in f for f in files):
            raise AssertionError(f"be_collapse_mhd: no {want} bin in {files}")
    mp = [float(v) for v in phys.pgrav.mp_coeffs[:4]]
    out["be_collapse_mhd"] = {"zcps": driver.zcps, "files": files,
                              "mp_coeffs": mp}
    print(f"phase 20: be_collapse_mhd as shipped (f64): {NCYC_GRAV} cycles, "
          f"files {files}, multipole coefficients 0-3 {mp}; [{card}] "
          f"zone-cycles/s {driver.zcps:.6e}")
    res = {}
    for use in ("true", "false"):
        got, mesh, phys, driver, state, _ = grav_cli(
            torch, kernels, BE_MHD, ["job/precision=single",
                                     f"mhd/use_kernels={use}"], NCYC_GRAV)
        expect_launches(f"be_collapse_mhd f32 {use}", got, {
            "fused_flux_dir": 6 * NCYC_GRAV} if use == "true" else {})
        res[use] = (state, [(r["ncycle"], r["leaves"])
                            for r in driver.pamr.updates], phys)
        out[f"be_collapse_mhd f32 {use}"] = {"launches": got,
                                            "zcps": driver.zcps}
        print(f"phase 20: be_collapse_mhd f32 use_kernels={use}: launches "
              f"{got}; [{card}] zone-cycles/s {driver.zcps:.6e}")
    ks, kt, kp = res["true"]
    ps, pt, _ = res["false"]
    if kt != pt:
        raise AssertionError("be_collapse_mhd: the paths took other trees")
    diff = {k: range_diff(a, b) for k, a, b in
            [("u", ks["u"], ps["u"])]
            + [(c, ks["bfc"][c], ps["bfc"][c]) for c in ks["bfc"]]}
    for k, d in diff.items():
        if not (d[0] > 0.95 and d[1] < SMR_PATH_TOL[1]):
            raise AssertionError(f"be_collapse_mhd: paths apart in {k}: {d}")
    from athenak_tpu_torch.ops import flux
    w, bcc, bfc = ks["w"], ks["bcc"], ks["bfc"]
    err = 0.0
    for name, _axis, ivx, _dx in kp.dirs:
        args = (w, bcc, bfc[f"{name}f"], kp.eos, name, ivx)
        for g, r in zip(flux.fused_flux_dir(*args),
                        flux.flux_dir_plain(*args)):
            g, r = faces(g), faces(r)
            err = max(err, two_tier(g, r, float(r.abs().max()) or 1.0,
                                    f"be_collapse_mhd fused_flux_dir"))
    out["be_collapse_mhd f32 path_diff"] = diff
    print(f"phase 20: be_collapse_mhd f32 kernel vs plain path {diff}; "
          f"fused_flux_dir agrees with its plain version on its "
          f"{list(w.shape)} state (f32 two-tier, max abs {err:.3e})")
    del res, ks, ps, w, bcc, bfc
    out["restart"] = be_restart(torch, kernels)
    out["flux_dir_err"] = err
    return out


def be_restart(torch, kernels):
    """be_collapse_mhd (f64): 10 cycles straight against 5, a .rst (after
    the tree update of cycle 5, the potential of the old tree in it),
    then -r and 5 more: u, the face field and phi bitwise equal."""
    from athenak_tpu_torch import main as cli_main
    n = NCYC_GRAV // 2
    common = ["output4/dcycle=5"]
    cwd = os.getcwd()
    os.environ["ATHENAK_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        try:
            m1, _, _, s1 = cli_main.cli([
                "-i", BE_MHD, "-d", os.path.join(tmp, "straight"), *common,
                f"time/nlim={2 * n}"])
            os.chdir(cwd)
            cli_main.cli(["-i", BE_MHD, "-d", os.path.join(tmp, "first"),
                          *common, f"time/nlim={n}"])
            os.chdir(cwd)
            rst = os.path.join(tmp, "first", "be_collapse.00001.rst")
            kernels.reset_counts()
            m2, _, _, s2 = cli_main.cli(["-r", rst, "-d",
                                         os.path.join(tmp, "first"),
                                         f"time/nlim={2 * n}"])
            resumed = {k.name: k.launches for k in kernels.ALL if k.launches}
        finally:
            os.chdir(cwd)
    if m1.leaves != m2.leaves or m2.ncycle != 2 * n:
        raise AssertionError("be_collapse_mhd restart: trees differ")
    for key in ("u", "phi"):
        if not torch.equal(s1[key], s2[key]):
            raise AssertionError(f"be_collapse_mhd restart: {key} not "
                                 "bitwise")
    for c in s1["bfc"]:
        if not torch.equal(s1["bfc"][c], s2["bfc"][c]):
            raise AssertionError(f"be_collapse_mhd restart: {c} not bitwise")
    print(f"phase 20: restart be_collapse_mhd (f64): {2 * n} cycles straight "
          f"and {n} + -r {n} bitwise equal (u, face field, phi; the .rst "
          f"carries phi), {m2.nmb_total} blocks; launches resumed {resumed}")
    return {"resumed": resumed, "nmb": m2.nmb_total}


def phase_grav(torch, kernels, card):
    """Phase 20's runs that time something: diffusion and self-gravity
    (see the module docstring); its bars and the Bonnor-Ebert runs go in
    lanes (``LANES``)."""
    seconds = {}

    def part(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t
        return out

    blast = part("diff_blast", diff_blast, torch, kernels, card)
    jeans = part("jeans", fill_runs, torch, kernels, card, "jeans_wave",
                 JEANS, JEANS_BIG, "periodic_fill_cc", 0)
    selfg = part("selfgravity", fill_runs, torch, kernels, card,
                 "selfgravity", SELFGRAV, SELFGRAV_BIG, None, 0)
    print(f"phase 20: seconds a part {seconds}")
    return {"diff_blast": blast, "jeans": jeans, "selfgravity": selfg,
            "seconds": seconds}


def grav_runs(grav):
    """Phase 20's launch counts by run, once its bars are in."""
    be = grav["be"]
    blast = grav["diff_blast"]["runs"]
    return {**{k: v["launches"] for k, v in blast.items()},
            "jeans_big": grav["jeans"]["true"]["launches"],
            "selfgravity_big": grav["selfgravity"]["true"]["launches"],
            **{k: v["launches"] for k, v in be.items()
               if isinstance(v, dict) and "launches" in v},
            "be_collapse_mhd restart": be["restart"]["resumed"]}


# ---------------------------------------------------------------- phase 21
NCYC_SBOX = 10
SBOX_DIR = os.path.join(ROOT, "inputs", "shearing_box")
SBOX_SHIPPED = ("epicycle", "hydro_compress_shwave", "hydro_orb_adv",
                "mri2d", "mri3d", "mri3d_stratified", "mri3d_unstratified")
SBOX_UNSTRAT = os.path.join(SBOX_DIR, "mri3d_unstratified.athinput")
SBOX_WIDE = ["mesh/nx1=128", "mesh/nx2=256", "mesh/nx3=64"]
RANDOM_DRIFT = os.path.join(ROOT, "inputs", "particles",
                            "random_drift.athinput")
DRAG_DECK = os.path.join(ROOT, "inputs", "ion-neutral", "drag.athinput")
SINGLE = ["job/precision=single"]


def test_literal(fname, name):
    """A literal assigned at the top level of one of the repo's test
    files (a deck's text, a table), read with ``ast``: phase 21 holds the
    port to those tests' bars on their own decks, and imports nothing of
    them (they import the JAX package)."""
    import ast
    with open(os.path.join(ROOT, "tests", fname)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            value = node.value
            if isinstance(value, ast.Call):        # np.array([...])
                value = value.args[0]
            return ast.literal_eval(value)
    raise KeyError(f"tests/{fname} assigns no {name}")


def particles_block():
    """random_drift's ``<particles>`` block, as text."""
    with open(RANDOM_DRIFT) as f:
        text = f.read()
    block = text[text.index("<particles>"):]
    return block[:block.index("\n<", 1) + 1]


def expect21(label, got, expect):
    expect_launches(label, got, expect, phase="21")


def mhd_div(torch, phys, state, label, limit):
    """``div_b``'s measure of an MHD state over its interior (the deck's
    ghost depth off every side), at most ``limit``."""
    d = div_b(torch, phys, state["bfc"], phys.mesh.mb_indcs.ng)[0]
    if not d <= limit:
        raise AssertionError(f"phase 21 {label}: max|div B| dx / max|B| = "
                             f"{d:g} > {limit:g}")
    return d


def sbox_shipped(torch, kernels, card, tmp):
    """The nine decks as shipped (float64) for NCYC_SBOX cycles: no
    kernel launches (the shearing box closes A, C, D and E and
    shear_periodic B and G; the other decks are isothermal, WENO-Z with
    HLLE, PPM4 or hydro; f64 closes every kernel), the state finite, div
    B at round-off."""
    decks = {n: os.path.join(SBOX_DIR, f"{n}.athinput")
             for n in SBOX_SHIPPED}
    decks["random_drift"] = RANDOM_DRIFT
    decks["drag"] = DRAG_DECK
    out = {}
    for label, deck in decks.items():
        got, mesh, phys, driver, state, files = grav_cli(
            torch, kernels, deck, ncyc=NCYC_SBOX)
        expect21(label, got, {})
        divb = mhd_div(torch, phys.pmhd if hasattr(phys, "pmhd") else phys,
                       state, label, 1e-12) if "bfc" in state else None
        out[label] = {"launches": got, "zcps": driver.zcps, "divb": divb}
        print(f"phase 21: {label} as shipped (f64, {mesh.nmb_total} "
              f"blocks of {mesh.mb_indcs.nx1}x{mesh.mb_indcs.nx2}x"
              f"{mesh.mb_indcs.nx3}): {NCYC_SBOX} cycles, launches {got}, "
              f"div(B) {divb}, files {files}; [{card}] CLI zone-cycles/s "
              f"{driver.zcps:.6e} (wall clock)")
    return out


def sbox_parts(torch, phys, state, driver):
    """ms (events) of the parts of a cycle of a shearing-box MHD deck on
    its state: the orbital advection of u and of the faces, the sheared
    remap of u and of the faces, J's three directions, the source terms,
    one whole stage and one whole cycle."""
    from athenak_tpu_torch.ops import flux
    sb = phys.psbox
    dt = driver.mesh.dt
    w, bcc, bfc, u = state["w"], state["bcc"], state["bfc"], state["u"]
    saved = phys.save_state(state)
    cycle = driver.make_cycle_fn()
    return {
        "orbital_advect": cuda_ms(lambda: sb.orbital_advect(u, dt), 10),
        "orbital_advect_fc": cuda_ms(lambda: sb.orbital_advect_fc(bfc, dt),
                                     10),
        "remap_ghosts": cuda_ms(lambda: sb.remap_ghosts(u.clone(),
                                                        state["t"]), 10),
        "remap_ghosts_fc": cuda_ms(lambda: sb.remap_ghosts_fc(
            {k: v.clone() for k, v in bfc.items()}, state["t"]), 10),
        "fused_flux_dir x3": sum(cuda_ms(lambda d=d: flux.fused_flux_dir(
            w, bcc, bfc[f"{d[0]}f"], phys.eos, d[0], d[2]), 10)
            for d in phys.dirs),
        "src_terms": cuda_ms(lambda: sb.src_terms(u, w, 1e-3,
                                                  phys.eos.is_ideal, bcc),
                             10),
        "stage": cuda_ms(lambda: phys.stage_update(state, saved, 0.0, 1.0,
                                                   dt), 5),
        "cycle": cuda_ms(lambda: cycle(state, dt), 5)}


def sbox_f32(torch, kernels, card):
    """mri3d_unstratified as shipped and at SBOX_WIDE in float32 on the
    kernel path (J three times a stage, nothing else, exact) and the
    plain path (nothing): div(B) <= 1e-5, the paths within
    SMR_PATH_TOL's tiers of what they changed; J against its plain
    version on SBOX_WIDE's state (f32 two-tier); the parts of a cycle and
    both paths' zone-cycles/s in turns."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import flux
    n = NCYC_SBOX
    out = {}
    for label, extra in (("mri3d_unstratified f32", SINGLE),
                         ("sbox_wide", SINGLE + SBOX_WIDE)):
        states = {}
        for use in ("true", "false"):
            got, mesh, phys, driver, state, _ = grav_cli(
                torch, kernels, SBOX_UNSTRAT,
                extra + [f"mhd/use_kernels={use}"], n)
            expect21(f"{label} {use}", got,
                        {"fused_flux_dir": 6 * n} if use == "true" else {})
            if phys.psbox is None or phys.use_flux_dir != (use == "true"):
                raise AssertionError(f"{label} {use}: J's gate or the "
                                     "shearing box is not as expected")
            divb = mhd_div(torch, phys, state, label, 1e-5)
            states[use] = state
            out[f"{label} {use}"] = {"launches": got, "zcps": driver.zcps,
                                     "divb": divb}
            print(f"phase 21: {label} use_kernels={use}: {n} cycles, "
                  f"launches {got}, div(B) {divb:.3e}; [{card}] CLI "
                  f"zone-cycles/s {driver.zcps:.6e} (wall clock)")
        state0 = build(pin_for(extra, SBOX_UNSTRAT), device="cuda")[-1]
        ka, pa = states["true"], states["false"]
        diff = {k: change_diff(a, b, c) for k, a, b, c in
                [("u", ka["u"], pa["u"], state0["u"])]
                + [(c, ka["bfc"][c], pa["bfc"][c], state0["bfc"][c])
                   for c in ("x1f", "x2f", "x3f")]}
        for k, d in diff.items():
            if not (d[0] > 0.95 and d[1] < SMR_PATH_TOL[1]):
                raise AssertionError(f"{label}: paths apart in {k}: {d}")
        del state0, pa
        out[label] = {"path_diff": diff}
        print(f"phase 21: {label} kernel vs plain path {diff}")
        if label != "sbox_wide":
            continue
        w, bcc, bfc = ka["w"], ka["bcc"], ka["bfc"]
        err = 0.0
        for name, _axis, ivx, _dx in phys.dirs:
            args = (w, bcc, bfc[f"{name}f"], phys.eos, name, ivx)
            for g, r in zip(flux.fused_flux_dir(*args),
                            flux.flux_dir_plain(*args)):
                g, r = faces(g), faces(r)
                err = max(err, two_tier(g, r, float(r.abs().max()) or 1.0,
                                        f"sbox_wide fused_flux_dir {name}"))
        parts = sbox_parts(torch, phys, ka, driver)
        rates = turn_rates(torch, SBOX_UNSTRAT, extra, "mhd")
        out[label].update({"flux_dir_err": err, "parts_ms": parts,
                           "rates": rates})
        print(f"phase 21: fused_flux_dir agrees with its plain version on "
              f"the SBOX_WIDE state (f32 two-tier, max abs {err:.3e}); "
              f"[{card}] ms of a cycle's parts {parts}; zone-cycles/s in "
              f"turns (events, after a warm-up cycle) {rates}")
    return out


def particle_runs(torch, kernels, card, tmp):
    """random_drift in float32 on both paths (B once at the start and
    once a stage; the paths bitwise, the drift x0 + v t wrapped) and
    PART_BLAST (the 124^3 blast with random_drift's particles: E and F
    twice a cycle, the face fill after every E, B once; A never; the
    paths within SMR_PATH_TOL's tiers, each path's particles at x0 + v t
    of its own time)."""
    from athenak_tpu_torch.main import build
    n = NCYC_SBOX
    out = {}
    res = {}
    for use in ("true", "false"):
        got, mesh, phys, driver, state, files = grav_cli(
            torch, kernels, RANDOM_DRIFT,
            SINGLE + [f"hydro/use_kernels={use}"], n)
        expect21(f"random_drift f32 {use}", got,
                    {"periodic_fill_cc": 1 + 2 * n} if use == "true" else {})
        res[use] = state
        out[f"random_drift f32 {use}"] = {"launches": got,
                                          "zcps": driver.zcps}
        print(f"phase 21: random_drift f32 use_kernels={use}: launches "
              f"{got}, files {files}; [{card}] CLI zone-cycles/s "
              f"{driver.zcps:.6e}")
    for key in ("u", "w", "prtcl_x", "prtcl_v"):
        if not torch.equal(res["true"][key], res["false"][key]):
            raise AssertionError(f"random_drift f32: {key} differs between "
                                 "the paths")
    st0 = build(pin_for(SINGLE, RANDOM_DRIFT), device="cuda")[-1]
    x0, v0 = st0["prtcl_x"].double(), st0["prtcl_v"].double()
    want = -0.5 + torch.remainder(x0 + v0 * mesh.time + 0.5, 1.0)
    drift = float((res["true"]["prtcl_x"].double() - want).abs().max())
    if not drift < 1e-5:
        raise AssertionError(f"random_drift f32: drift off by {drift:g}")
    out["random_drift drift_err"] = drift
    out_times = {}
    deck = os.path.join(tmp, "part_blast.athinput")
    with open(DECK) as f:
        text = f.read()
    with open(deck, "w") as f:
        f.write(text + "\n" + particles_block())
    states = {}
    for use in ("true", "false"):
        got, mesh, phys, driver, state, _ = grav_cli(
            torch, kernels, deck, [f"mhd/use_kernels={use}"], n)
        expect21(f"part_blast {use}", got, {
            "mega_stage_v1": 2 * n, "fused_aux3d": 2 * n,
            "periodic_fill_fc": 2 * n + 1, "periodic_fill_cc": 1}
            if use == "true" else {})
        divb = mhd_div(torch, phys, state, "part_blast", 1e-5)
        states[use] = state
        out_times[use] = mesh.time
        out[f"part_blast {use}"] = {"launches": got, "zcps": driver.zcps,
                                    "divb": divb}
        print(f"phase 21: part_blast (124^3 f32, {phys.ppart.nprtcl} "
              f"particles) use_kernels={use}: launches {got}, div(B) "
              f"{divb:.3e}; [{card}] CLI zone-cycles/s {driver.zcps:.6e}")
    state0 = build(pin_for([], deck), device="cuda")[-1]
    diff = {k: change_diff(a, b, c) for k, a, b, c in
            [("u", states["true"]["u"], states["false"]["u"], state0["u"])]}
    for k, d in diff.items():
        if not (d[0] > 0.95 and d[1] < SMR_PATH_TOL[1]):
            raise AssertionError(f"part_blast: paths apart in {k}: {d}")
    # each path's own dt chain (F's state or the plain c2p) drifts the
    # particles: each must be x0 + v t at its own time
    x0, v0 = state0["prtcl_x"].double(), state0["prtcl_v"].double()
    for use, st in states.items():
        t = out_times[use]
        want = -1.0 + torch.remainder(x0 + v0 * t + 1.0, 2.0)
        err = float((st["prtcl_x"].double() - want).abs().max())
        if not err < 1e-5:
            raise AssertionError(f"part_blast {use}: drift off by {err:g}")
        out[f"part_blast {use}"]["drift_err"] = err
    out["part_blast path_diff"] = diff
    print(f"phase 21: part_blast kernel vs plain path {diff}")
    return out


def run_deck_text(torch, text, extra=()):
    """``main.run`` on a deck's text on the card in a temporary
    directory: (mesh, phys, driver, state, {file name: text of the
    history and error files})."""
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.main import run
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(list(extra))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            mesh, phys, driver, state = run(pin, device="cuda")
        finally:
            os.chdir(cwd)
        hst = {}
        for f in os.listdir(tmp):
            if f.endswith((".hst", "-errs.dat")):
                with open(os.path.join(tmp, f)) as fh:
                    hst[f] = fh.read()
    return mesh, phys, driver, state, hst


def epicycle_bar(torch, card):
    """tests/test_shearing_box.py::test_epicyclic_oscillation on the
    card (f64): after one epicyclic period a uniform vx kick of 1e-3 is
    back within 5%, vy below 0.3 of it."""
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.main import build
    kappa = math.sqrt(2.0 * (2.0 - 1.5))
    text = test_literal("test_shearing_box.py", "BASE").format(
        tlim=2.0 * math.pi / kappa, nscalars=0)
    mesh, phys, _, driver, state = build(ParameterInput.from_string(text),
                                         device="cuda")
    amp = 1.0e-3
    u = state["u"].clone()
    u[:, 1] += amp * u[:, 0]
    w, u, _ = phys.cons_to_prim(u)
    state = driver.execute(driver.initialize(dict(state, u=u, w=w)))
    mbi = mesh.mb_indcs
    act = (0, slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    vx, vy = state["w"][:, 1][act], state["w"][:, 2][act]
    ok = bool(((vx - amp).abs() <= 1e-8 + 0.05 * amp).all()) \
        and float(vy.abs().max()) < 0.3 * amp
    res = {"cycles": mesh.ncycle, "vx_err": float((vx - amp).abs().max())
           / amp, "vy_max": float(vy.abs().max()) / amp,
           "zcps": driver.zcps}
    if not ok:
        raise AssertionError(f"epicycle bar: {res}")
    return res


def shwave_bar(torch, card):
    """tests/test_shearing_box_mhd.py::test_mhd_shwave on the card
    (f64): the dByc history against the semi-analytic table, mean error
    below 2.1e-8, and div(B) below 1e-12."""
    import numpy as np
    table = np.asarray(test_literal("test_shearing_box_mhd.py", "DBYC"))
    mesh, phys, driver, state, hst = run_deck_text(
        torch, test_literal("test_shearing_box_mhd.py", "DECK"))
    labels, rows = hst_table(hst["shwave4.user.hst"])
    data = np.asarray(rows)
    ref = np.interp(data[:, 0], np.linspace(0.0, 3.0, 301), table)
    err = float(np.abs(data[:, 2] - ref).mean())
    b = {k: v.double() for k, v in state["bfc"].items()}
    dx = [phys.dxs[k] for k in ("x1", "x2", "x3")]
    div = ((b["x1f"][..., 1:] - b["x1f"][..., :-1]) / dx[0]
           + (b["x2f"][..., 1:, :] - b["x2f"][..., :-1, :]) / dx[1]
           + (b["x3f"][:, 1:] - b["x3f"][:, :-1]) / dx[2])
    divb = float(interior(div, mesh.mb_indcs.ng).abs().max())
    res = {"cycles": mesh.ncycle, "rows": len(rows), "mean_err": err,
           "divb": divb, "zcps": driver.zcps}
    if not (err < 2.1e-8 and divb < 1e-12 and labels[-1] == "dByc"):
        raise AssertionError(f"MHD shwave bar: {res}")
    return res


def mri3d_bar(torch, card):
    """tests/test_mri3d.py::test_mri3d_linear_growth on the card (f64):
    the radial field energy grows past twice its minimum near t ~ 4, the
    toroidal energy stays below 1, the Maxwell stress is positive after
    t = 1 and grows 1.5-fold."""
    import numpy as np
    mesh, phys, driver, state, hst = run_deck_text(
        torch, test_literal("test_mri3d.py", "DECK"))
    labels, rows = hst_table(hst["HGB.user.hst"])
    data = np.asarray(rows)
    col = {lab: data[:, i] for i, lab in enumerate(labels)}
    t, me1, me3, dbxby = col["time"], col["1-ME"], col["3-ME"], col["dBxBy"]
    tmin = float(me1[(t > 3.5) & (t < 4.5)].min())
    late = float(me1[t > 5.8].max())
    grow = float(dbxby[t > 5.8].max()
                 / dbxby[(t > 2.5) & (t < 3.5)].mean())
    res = {"cycles": mesh.ncycle, "me1_min": tmin, "me1_late": late,
           "me3_max": float(me3.max()), "dbxby_growth": grow,
           "zcps": driver.zcps}
    ok = (all(c in labels for c in ("1-KE", "1-ME", "2-ME", "3-ME",
                                     "dVxVy", "dBxBy"))
          and bool(torch.isfinite(state["u"]).all())
          and late > 2.0 * tmin and np.isfinite(me1).all()
          and me3.max() < 1.0 and (dbxby[t > 1.0] > 0.0).all()
          and grow > 1.5)
    if not ok:
        raise AssertionError(f"mri3d bar: {res}")
    return res


def drag_bars(torch, card):
    """tests/test_ion_neutral.py on the card (f64): the drag relaxation
    under imex2 and imex3 (dv within 0.03 dv0 of dv0 exp(-gamma (d_i +
    d_n) t), the total momentum to 1e-12) and the stiff drag (1e6,
    within 0.01 of the centre-of-momentum velocity)."""
    text = test_literal("test_ion_neutral.py", "DECK")
    out = {}
    di, dn, dv0 = 0.4, 1.2, 0.2
    p0 = di * 0.1 + dn * (-0.1)
    vcom = p0 / (di + dn)
    for integ in ("imex2", "imex3"):
        mesh, phys, driver, st, _ = run_deck_text(
            torch, text.format(integ=integ, drag=4.0, tlim=0.4))
        ui, un = interior(st["ui"]).double(), interior(st["u"]).double()
        vi = float((ui[:, 1] / ui[:, 0]).mean())
        vn = float((un[:, 1] / un[:, 0]).mean())
        dv = dv0 * math.exp(-4.0 * (di + dn) * mesh.time)
        dp = abs(float(ui[:, 1].mean() + un[:, 1].mean()) - p0)
        out[integ] = {"cycles": mesh.ncycle, "dv_err": abs(vi - vn - dv)
                      / dv0, "momentum_err": dp}
        if not (abs((vi - vn) - dv) < 0.03 * dv0 and dp < 1e-12
                and abs(vi - (vcom + dn / (di + dn) * dv)) < 0.03 * dv0):
            raise AssertionError(f"drag bar {integ}: {out[integ]}")
    mesh, phys, driver, st, _ = run_deck_text(
        torch, text.format(integ="imex2", drag=1.0e6, tlim=0.05))
    ui, un = st["ui"].double(), st["u"].double()
    off = max(float((ui[:, 1] / ui[:, 0] - vcom).abs().max()),
              float((un[:, 1] / un[:, 0] - vcom).abs().max()))
    dp = abs(float(ui[:, 1].mean() + un[:, 1].mean()) - p0)
    out["stiff"] = {"cycles": mesh.ncycle, "v_off": off,
                    "momentum_err": dp}
    if not (off < 0.05 * 0.2 and dp < 1e-12):
        raise AssertionError(f"stiff drag bar: {out['stiff']}")
    return out


def phase_sbox(torch, kernels, card):
    """Phase 21's runs that time something: the shearing box, particles
    and the ion-neutral two-fluid (see the module docstring); its bars
    run in lanes (``LANES``)."""
    seconds = {}

    def part(label, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        seconds[label] = time.perf_counter() - t
        return res

    with tempfile.TemporaryDirectory() as tmp:
        shipped = part("shipped", sbox_shipped, torch, kernels, card, tmp)
        f32 = part("f32", sbox_f32, torch, kernels, card)
        parts = part("particles", particle_runs, torch, kernels, card, tmp)
    print(f"phase 21: seconds a part {seconds}")
    runs = {f"{k} shipped": v["launches"] for k, v in shipped.items()}
    runs.update({k: v["launches"] for k, v in {**f32, **parts}.items()
                 if isinstance(v, dict) and "launches" in v})
    return {"runs": runs, "shipped": {k: {kk: vv for kk, vv in v.items()
                                          if kk != "launches"}
                                      for k, v in shipped.items()},
            "f32": f32, "particles": {k: v for k, v in parts.items()
                                      if not (isinstance(v, dict)
                                              and "launches" in v)},
            "seconds": seconds}


NCYC_RAD = 5
NCYC_WIDE = 3
RAD_LINWAVE = os.path.join(ROOT, "inputs", "tests", "rad_linwave.athinput")
RAD_SHIPPED = {n: os.path.join(ROOT, "inputs", "radiation", f"{n}.athinput")
               for n in ("hohlraum_1d", "relax", "shadow", "snake")}
RAD_SHIPPED["rad_linwave"] = RAD_LINWAVE
RAD_WIDE = ["mesh/nx1=128", "mesh/nx2=128", "mesh/nx3=128",
            "problem/along_x1=true", "job/precision=single"]
RAD_POOL = RAD_WIDE + ["meshblock/nx1=64", "meshblock/nx2=64",
                       "meshblock/nx3=64"]


def expect22(label, got, expect):
    expect_launches(label, got, expect, phase="22")


def rad_state_finite(torch, state, label):
    """Every entry of a radiation state finite (i0, and u, w of a coupled
    fluid)."""
    for key in ("u", "w", "i0"):
        if key in state and not bool(torch.isfinite(state[key]).all()):
            raise AssertionError(f"phase 22 {label}: non-finite {key}")


def rad_shipped(torch, kernels, card, tmp):
    """The five shipped radiation decks, tests/test_rad_gr.py's beam in
    Kerr and tests/test_radiation.py's diffusion deck as they are
    (float64), NCYC_RAD cycles through the CLI: no launch (float64 closes
    B and G; only rad_linwave is periodic, and it is 1-D), the state
    finite."""
    decks = dict(RAD_SHIPPED)
    for name, (fname, var, fmt) in {
            "beam_kerr": ("test_rad_gr.py", "BEAM_DECK", None),
            "diffusion": ("test_radiation.py", "DIFF_DECK", 1.0)}.items():
        text = test_literal(fname, var)
        decks[name] = os.path.join(tmp, f"{name}.athinput")
        with open(decks[name], "w") as f:
            f.write(text if fmt is None else text.format(tlim=fmt))
    out = {}
    for label, deck in decks.items():
        got, mesh, phys, driver, state, files = grav_cli(
            torch, kernels, deck, ncyc=NCYC_RAD)
        expect22(label, got, {})
        rad_state_finite(torch, state, label)
        mbi = mesh.mb_indcs
        out[label] = {"launches": got, "zcps": driver.zcps,
                      "angles": getattr(phys, "rad", phys).nangles}
        print(f"phase 22: {label} as shipped (f64, {mesh.nmb_total} blocks "
              f"of {mbi.nx1}x{mbi.nx2}x{mbi.nx3}, "
              f"{out[label]['angles']} angles): {NCYC_RAD} cycles, "
              f"launches {got}, files {files}; [{card}] CLI zone-cycles/s "
              f"{driver.zcps:.6e} (wall clock)")
    return out


def rad_stage_parts(torch, phys, state, driver):
    """ms (events) of the parts of a stage of a radiation-fluid deck on
    its state: the intensity transport (fluxes and the update), the
    coupling, the fluid's stage, the fills of u and i0, one whole stage
    and one whole cycle."""
    from athenak_tpu_torch.radiation.coupling import rad_fluid_coupling
    rad, dt = phys.rad, driver.mesh.dt
    saved = phys.save_state(state)
    i0, u, w = state["i0"], state["u"], state["w"]
    gm1 = phys.eos.gamma - 1.0
    cycle = driver.make_cycle_fn()
    return {
        "transport": cuda_ms(lambda: rad.floor(rad.rk_update(
            i0, saved["i1"], rad.fluxes(i0), 0.0, 1.0, dt)), 5),
        "coupling": cuda_ms(lambda: rad_fluid_coupling(rad, i0, u, w, gm1,
                                                       dt), 5),
        "fluid_stage": cuda_ms(lambda: phys.fluid.stage_update(
            state, saved, 0.0, 1.0, dt), 5),
        "fills u+i0": cuda_ms(lambda: (phys.bvals.fill_ghosts(u.clone()),
                                       phys.bvals.fill_ghosts(i0.clone())),
                              5),
        "clones u+i0": cuda_ms(lambda: (u.clone(), i0.clone()), 5),
        "stage": cuda_ms(lambda: phys.stage_update(state, saved, 0.0, 1.0,
                                                   dt), 3),
        "cycle": cuda_ms(lambda: cycle(state, dt), 3)}


def rad_fill_checks(torch, phys, state, key):
    """Kernel B (one block) or G (a pool) against its plain version on
    the run's [nmb, 42, n3, n2, n1] intensities, bitwise, and their times
    beside the bound (every ghost read once and written once)."""
    from athenak_tpu_torch.ops import fill, pool_fill
    i0 = state["i0"]
    mesh = phys.mesh
    if key == "periodic_fill_cc":
        def kern(a):
            return fill.periodic_fill_cc(a)

        def plain(a):
            return fill.fill_plain(a, fill.shifts(a.shape))
    else:
        nbr = phys.bvals.nbr27(i0.device)

        def kern(a):
            return pool_fill.pool_fill_cc(a, nbr, mesh)

        def plain(a):
            return pool_fill.pool_fill_plain([a], ["cc"], nbr, mesh)
    gen = torch.Generator(device="cuda").manual_seed(22)
    noisy = i0 * (1.0 + torch.rand(i0.shape, generator=gen, device="cuda",
                                   dtype=i0.dtype))
    a, b = kern(noisy.clone()), noisy.clone()
    plain(b)
    if not torch.equal(a, b):
        raise AssertionError(f"phase 22 {key}: not bitwise equal to its "
                             f"plain version at {tuple(i0.shape)}")
    mbi = mesh.mb_indcs
    ghosts = i0.numel() - mesh.nmb_total * i0.shape[1] \
        * mbi.nx1 * mbi.nx2 * mbi.nx3
    work = noisy.clone()
    return {"shape": list(i0.shape), "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: kern(work), 20),
            "plain_ms": cuda_ms(lambda: plain(work), 10),
            "bound": bound(2 * ghosts * i0.element_size(), 0)}


def rad_wide(torch, kernels, card):
    """RAD_WIDE (one 128^3 block) and RAD_POOL (8 x 64^3) in float32 on
    the kernel path and the plain path (``hydro/use_kernels``), the launch
    counts checked exactly (B or G 2 + 6 n in n cycles: u and i0 at the
    start; u in the fluid stage, u after the coupling and i0 in each
    stage), the paths bitwise equal, the fill kernel bitwise equal to its
    plain version on the intensities, the ms of a stage's parts and both
    paths' zone-cycles/s in turns."""
    n = NCYC_WIDE
    out = {}
    for label, extra, key in (("rad_wide", RAD_WIDE, "periodic_fill_cc"),
                              ("rad_pool", RAD_POOL, "pool_fill")):
        states = {}
        for use in ("true", "false"):
            got, mesh, phys, driver, state, _ = grav_cli(
                torch, kernels, RAD_LINWAVE,
                extra + [f"hydro/use_kernels={use}"], n)
            expect22(f"{label} {use}", got,
                     {key: 2 + 6 * n} if use == "true" else {})
            rad_state_finite(torch, state, label)
            states[use] = state
            out[f"{label} {use}"] = {"launches": got, "zcps": driver.zcps}
            print(f"phase 22: {label} use_kernels={use}: {n} cycles, "
                  f"launches {got}, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                  f"[{card}] CLI zone-cycles/s {driver.zcps:.6e} "
                  f"(wall clock)")
        for k in ("u", "w", "i0"):
            if not torch.equal(states["true"][k], states["false"][k]):
                raise AssertionError(f"phase 22 {label}: {k} differs "
                                     "between the kernel and plain paths")
        fills = rad_fill_checks(torch, phys, states["true"], key)
        parts = rad_stage_parts(torch, phys, states["true"], driver)
        del states
        rates = turn_rates(torch, RAD_LINWAVE, extra, "hydro")
        out[label] = {"fill": fills, "parts_ms": parts, "rates": rates}
        print(f"phase 22: {label}: the paths bitwise equal (u, w, i0); "
              f"{key} bitwise equal to its plain version on "
              f"{fills['shape']}; [{card}] {key} {fills['ms']:.4f} ms, "
              f"plain {fills['plain_ms']:.4f} ms, bound "
              f"{fills['bound'][0]:.5f} ms; ms of a stage's parts {parts}; "
              f"zone-cycles/s in turns (events, after a warm-up cycle) "
              f"{rates}")
        torch.cuda.empty_cache()
    return out


def rad_run(torch, text, extra=()):
    """``run_deck_text`` with the radiation state checked finite."""
    out = run_deck_text(torch, text, extra)
    rad_state_finite(torch, out[3], "bar")
    return out


def rad_interior(mesh, q):
    """The interior of a [nmb, n3, n2, n1] field."""
    mbi = mesh.mb_indcs
    return q[:, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1, mbi.is_:mbi.ie + 1]


def hohlraum_bar(torch):
    """tests/test_radiation.py::test_hohlraum_light_front: behind the
    front E > 0.6 of the half-space weight, ahead below 0.05 of it, the
    front between 0.8 t and t + 3 dx."""
    import numpy as np
    mesh, phys, driver, state, _ = rad_run(
        torch, test_literal("test_radiation.py", "DECK").format(opac=""))
    E = rad_interior(mesh, phys.moments(state["u"])[0]).double().cpu()
    E = E[0, 1, 1].numpy()
    mbi = mesh.mb_indcs
    x = mesh.cell_centers(0)[0][mbi.is_:mbi.ie + 1]
    t = mesh.time
    wpos = phys.grid.weights[phys.grid.nh[:, 0] > 0].sum()
    lit = np.where(E > 0.01 * wpos)[0]
    xfront, dx = x[lit[-1]], x[1] - x[0]
    res = {"cycles": mesh.ncycle, "behind": float(E[x < 0.5 * t].mean()
                                                  / wpos),
           "ahead": float(E[x > 1.2 * t].max() / wpos),
           "front_over_t": float(xfront / t)}
    if not (res["behind"] > 0.6 and res["ahead"] < 0.05
            and 0.8 * t < xfront <= t + 3 * dx):
        raise AssertionError(f"hohlraum bar: {res}")
    return res


def relax_bars(torch):
    """tests/test_radiation.py's relaxation: T^4 + T = 101 (rtol 1e-4,
    E_rad 1e-3, the sum 1e-10), and with Compton T^4 + T = 11 (the sum
    1e-6, both temperatures 2e-3)."""
    import numpy as np
    out = {}
    deck = test_literal("test_radiation.py", "RELAX_DECK")
    comp = deck.replace("kappa_a = 1.0", "kappa_a = 0.0") \
               .replace("kappa_s = 0.0", "kappa_s = 2.0") \
               .replace("temp = 100.0", "temp = 10.0") \
               .replace("cfl_number = 0.3", "cfl_number = 0.1") \
               .replace("tlim = 10.0", "tlim = 6.0") \
               .replace("<problem>", "<units>\ndensity_cgs = 1.0\n"
                        "bhmass_msun = 1.0\nmu = 5.486e-5\n\n<problem>")
    for label, text, extra, teq, tot in (
            ("absorption", deck, (), 3.1451803, 101.0),
            ("compton", comp, ("radiation/compton=true",), 1.7442276,
             11.0)):
        mesh, phys, driver, state, _ = rad_run(torch, text, extra)
        mbi = mesh.mb_indcs
        w = state["w"].double().cpu().numpy()[:, :, mbi.ks:mbi.ke + 1,
                                              mbi.js:mbi.je + 1,
                                              mbi.is_:mbi.ie + 1]
        tgas = w[:, 4] / w[:, 0]
        er = rad_interior(mesh, phys.coord_energy_density(state)).double()
        er = er.cpu().numpy()
        res = {"cycles": mesh.ncycle, "tgas": float(tgas.mean()),
               "erad": float(er.mean()),
               "sum_err": float(np.abs(tgas + er - tot).max() / tot)}
        if label == "absorption":
            ok = (np.allclose(tgas, teq, rtol=1e-4)
                  and np.allclose(er, tot - teq, rtol=1e-3)
                  and np.allclose(tgas + er, tot, rtol=1e-10))
        else:
            trad = er.mean() ** 0.25
            res["trad"] = float(trad)
            ok = (np.allclose(tgas + er, tot, rtol=1e-6)
                  and np.allclose(tgas, teq, rtol=2e-3)
                  and np.allclose(trad, teq, rtol=2e-3))
        out[label] = res
        if not ok:
            raise AssertionError(f"relax bar {label}: {res}")
    return out


def shadow_bar(torch):
    """tests/test_radiation.py::test_rad_shadow: behind the cloud the lit
    rows carry E > 1e-3 and the shadowed row less than 0.2 of it."""
    mesh, phys, driver, state, _ = rad_run(
        torch, test_literal("test_radiation.py", "SHADOW_DECK"))
    er = phys.rad.coord_energy_density(state).double().cpu()
    mbi = mesh.mb_indcs
    i = mbi.is_ + int(0.9 * mbi.nx1)
    shadow = float(er[:, mbi.ks, mbi.js + mbi.nx2 // 2, i].min())
    lit = float(er[:, mbi.ks, mbi.js + 1, i].max())
    res = {"cycles": mesh.ncycle, "lit": lit, "shadow": shadow}
    if not (lit > 1.0e-3 and shadow < 0.2 * lit):
        raise AssertionError(f"shadow bar: {res}")
    return res


def diffusion_bar(torch):
    """tests/test_radiation.py::test_rad_diffusion_pulse: at t = 1 the
    pulse within 0.08 of the diffusion solution over |x| < 1."""
    import numpy as np
    tlim = 1.0
    mesh, phys, driver, state, _ = rad_run(
        torch, test_literal("test_radiation.py", "DIFF_DECK").format(
            tlim=tlim))
    mbi = mesh.mb_indcs
    er = phys.rad.coord_energy_density(state).double().cpu().numpy()
    x = mesh.cell_centers(0)[0][mbi.is_:mbi.ie + 1]
    prof = er[0, 0, 0, mbi.is_:mbi.ie + 1]
    nu, ks = 4.0, 40.0
    dd = 1.0 / (3.0 * ks)
    want = (np.exp(-nu ** 2 * x ** 2 / (4 * dd * nu ** 2 * tlim + 1.0))
            / np.sqrt(4 * dd * nu ** 2 * tlim + 1.0))
    core = np.abs(x) < 1.0
    err = float(np.abs(prof - want)[core].max() / want.max())
    res = {"cycles": mesh.ncycle, "err": err}
    if not err < 0.08:
        raise AssertionError(f"diffusion bar: {res}")
    return res


def lwave_run(res):
    """One of tests/test_rad_gr.py::test_rad_lwave1d_convergence's two
    runs on the card: ``res`` cells in four blocks to one damping time
    (2,824 and 5,647 cycles of a few thousand small launches at 32 and
    64 cells); its RMS L1 error, cycles and wall seconds."""
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.main import run
    pin = ParameterInput.from_string(test_literal("test_rad_gr.py",
                                                  "RAD_LWAVE_DECK"))
    pin.modify_from_cmdline([f"mesh/nx1={res}", f"meshblock/nx1={res // 4}"])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            mesh, _, driver, _ = run(pin, device="cuda")
            with open("rad_linwave-errs.dat") as f:
                row = f.read().splitlines()[-1].split()
        finally:
            os.chdir(cwd)
    return {"err": float(row[4]), "cycles": mesh.ncycle,
            "wall": driver.wall_seconds}


def lwave_bar(runs):
    """The convergence bar on the two runs' errors: the RMS L1 error at
    64 cells below 6e-7 and its ratio to 32 cells' below 0.32."""
    out = {}
    for res in (32, 64):
        rec = runs[f"lwave{res}"]
        out[f"cycles_{res}"] = rec["cycles"]
        out[f"wall_{res}"] = rec["wall"]
    out.update({"e32": runs["lwave32"]["err"], "e64": runs["lwave64"]["err"],
                "ratio": runs["lwave64"]["err"] / runs["lwave32"]["err"]})
    if not (out["e64"] < 6.0e-7 and out["ratio"] < 0.32):
        raise AssertionError(f"lwave bar: {out}")
    return out


def beam_bar(torch):
    """tests/test_rad_gr.py::test_rad_beam_kerr: 25 cycles of the beam in
    Kerr: E >= -1e-10, the excised cells empty, the total energy 2.1824
    within 5%, its centroid (3.767, 0.2105) within (0.1, 0.05), the
    peak 0.3551 within 5%."""
    mesh, phys, driver, state, _ = rad_run(
        torch, test_literal("test_rad_gr.py", "BEAM_DECK"))
    i0 = state["u"]
    E = phys.moments(i0)[0].double()
    mbi = mesh.mb_indcs
    Ea = rad_interior(mesh, E).cpu().numpy()
    tot = cx = cy = 0.0
    for gid in range(mesh.nmb_total):
        x1, x2, _ = mesh.cell_centers(gid)
        e = Ea[gid, 0]
        tot += e.sum()
        cx += (e * x1[mbi.is_:mbi.ie + 1][None, :]).sum()
        cy += (e * x2[mbi.js:mbi.je + 1][:, None]).sum()
    excised = float(i0[phys.excise_mask[:, None].expand_as(i0)].abs().max())
    res = {"cycles": mesh.ncycle, "total": float(tot),
           "cx": float(cx / tot), "cy": float(cy / tot),
           "emax": float(Ea.max()), "emin": float(E.min()),
           "excised_max": excised}
    if not (res["emin"] > -1e-10 and excised == 0.0
            and abs(tot - 2.1824) < 0.05 * 2.1824
            and abs(res["cx"] - 3.767) < 0.1
            and abs(res["cy"] - 0.2105) < 0.05
            and abs(res["emax"] - 0.3551) < 0.05 * 0.3551):
        raise AssertionError(f"beam bar: {res}")
    return res


def snake_bars(torch):
    """tests/test_rad_snake.py: the geometry tables (n^0 = 1, face n^x
    varying along y, finite nonzero edge speeds) and the beam's snake-x
    centroid tracking -A sin(k pi y) within 2.5 cells (Cartesian tetrad,
    nlevel 4) and 2 cells (snake-aligned tetrad at nlevel 8, 642
    angles) on at least 8 rows; the ms of divfa and of the fluxes on the
    final state."""
    import numpy as np
    text = test_literal("test_rad_snake.py", "DECK")
    out = {}
    for tet in ("false", "true"):
        deck = text.format(tlim=1.2, snake_tet=tet)
        if tet == "true":
            deck = deck.replace("nlevel = 4", "nlevel = 8")
        t0 = time.perf_counter()
        mesh, rad, driver, state, _ = rad_run(torch, deck)
        ndx = rad.nd_face["x1"]
        tables = (float((rad.n0 - 1.0).abs().max()) < 1e-14
                  and float((ndx[:, :, :, 1:] - ndx[:, :, :, :-1]).abs()
                            .max()) > 1e-3
                  and bool(torch.isfinite(rad.na).all())
                  and float(rad.na.abs().max()) > 0.0)
        E = rad.moments(state["u"])[0].double().cpu().numpy()
        mbi = mesh.mb_indcs
        A, k = 0.1, 2.0
        worst, checked = 0.0, 0
        tol = (2.5 if tet == "false" else 2.0) / 64
        for gid in range(mesh.nmb_total):
            x1v, x2v, _ = mesh.cell_centers(gid)
            for j in range(mbi.js, mbi.je + 1):
                y = x2v[j]
                if not (0.5 < y < (1.0 if tet == "false" else 0.75)):
                    continue
                row = E[gid, 0, j, mbi.is_:mbi.ie + 1]
                if row.max() <= 1e-8:
                    continue
                xs = x1v[mbi.is_:mbi.ie + 1]
                cen = (row * xs).sum() / row.sum()
                worst = max(worst, abs(cen + A * math.sin(k * math.pi * y)))
                checked += 1
        res = {"angles": rad.nangles, "cycles": mesh.ncycle,
               "worst_offset_cells": worst * 64, "rows": checked,
               "tables": tables, "seconds": time.perf_counter() - t0,
               "zcps": driver.zcps,
               "divfa_ms": cuda_ms(lambda: rad.divfa(state["u"]), 5),
               "transport_ms": cuda_ms(lambda: rad.fluxes(state["u"]), 5)}
        out[f"snake_tet={tet}"] = res
        if not (tables and worst < tol and checked >= 8):
            raise AssertionError(f"snake bar {tet}: {res}")
    return out


def phase_rad(torch, kernels, card):
    """Phase 22's runs that time something (see the module docstring):
    the shipped decks, RAD_WIDE and RAD_POOL, the snake; its other bars
    run in lanes (``LANES``)."""
    seconds = {}

    def part(label, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        seconds[label] = time.perf_counter() - t
        return res

    with tempfile.TemporaryDirectory() as tmp:
        shipped = part("shipped", rad_shipped, torch, kernels, card, tmp)
    wide = part("wide", rad_wide, torch, kernels, card)
    bars = {"snake": part("snake_bars", snake_bars, torch)}
    print(f"phase 22: seconds a part {seconds}")
    runs = {f"{k} shipped": v["launches"] for k, v in shipped.items()}
    runs.update({k: v["launches"] for k, v in wide.items()
                 if "launches" in v})
    return {"runs": runs,
            "shipped": {k: {kk: vv for kk, vv in v.items()
                            if kk != "launches"}
                        for k, v in shipped.items()},
            "wide": {k: v for k, v in wide.items() if "launches" not in v},
            "bars": bars, "seconds": seconds}


NCYC_DYN = 10
DYN_DIR = os.path.join(ROOT, "inputs", "dyn_grmhd")
DYN_SHIPPED = {n: os.path.join(DYN_DIR, f"{n}.athinput")
               for n in ("sod", "tov_cowling", "tov_z4c_smr", "dynbbh")}
# tov_z4c_smr at 64^3 in 32^3 blocks: the refined region covers the
# centre of every root block, so 64 blocks of 32^3 sit on level 1 (2.1 M
# cells, the hero blast's size), ng 4, coupled Z4c, float32
DYN_WIDE = ["mesh/nx1=64", "mesh/nx2=64", "mesh/nx3=64",
            "meshblock/nx1=32", "meshblock/nx2=32", "meshblock/nx3=32",
            "job/precision=single"]
NCYC_DYN_WIDE = 3
# dynbbh: its first tree check falls after cycle 4 (refinement_interval
# 4); two cycles past it
NCYC_BBH_DYN = 6


def expect23(label, got, expect):
    expect_launches(label, got, expect, phase="23")


def dyn_finite(torch, state, label):
    """Every cell entry of a dyngr state finite (u, w, T, z and the face
    field)."""
    for key in ("u", "w", "T", "z"):
        if key in state and not bool(torch.isfinite(state[key]).all()):
            raise AssertionError(f"phase 23 {label}: non-finite {key}")


def dyn_shipped(torch, kernels, card):
    """The four shipped decks as they are (float64) through the CLI:
    sod, tov_cowling and tov_z4c_smr NCYC_DYN cycles, dynbbh through its
    first tree update and two cycles past it with its ``hst`` output; no
    launch (f64, outflow sides, the matter closes H), the states finite,
    div(B) dx / max|B| <= 1e-5 on every level (the TOV decks carry no
    field: div B exactly 0)."""
    out = {}
    for label, deck in DYN_SHIPPED.items():
        n = NCYC_BBH_DYN if label == "dynbbh" else NCYC_DYN
        got, mesh, phys, driver, state, files = grav_cli(
            torch, kernels, deck, ncyc=n)
        expect23(label, got, {})
        dyn_finite(torch, state, label)
        div = check_levels(torch, mesh, state, f"phase 23 {label}")
        rec = {"launches": got, "zcps": driver.zcps, "div_b": div,
               "nmb": mesh.nmb_total}
        if label == "dynbbh":
            ups = driver.pamr.updates
            if not ups or ups[0]["ncycle"] != 4 or "dynbbh.hst" not in files:
                raise AssertionError(f"phase 23 dynbbh: updates {ups}, "
                                     f"files {files}")
            alpha = phys.adm_of(state)["alpha"]
            if alpha.shape[0] != mesh.nmb_total:
                raise AssertionError("phase 23 dynbbh: the spacetime was "
                                     "not rebound to the new tree")
            rec["updates"] = [(u["ncycle"], u["nmb"]) for u in ups]
        out[label] = rec
        mbi = mesh.mb_indcs
        print(f"phase 23: {label} as shipped (f64, {mesh.nmb_total} blocks "
              f"of {mbi.nx1}x{mbi.nx2}x{mbi.nx3}, levels "
              f"{sorted(set(int(v) for v in mesh.mb_lev))}): {n} cycles, "
              f"launches {got}, div B by level {div}, files {files}; "
              f"[{card}] CLI zone-cycles/s {driver.zcps:.6e} (wall clock, "
              f"{1e3 * driver.wall_seconds / n:.1f} ms a cycle)")
    return out


def dyn_density_drift(w, rhoc=1.28e-3):
    return abs(float(w[:, 0].max()) - rhoc) / rhoc


def tov_bars(torch):
    """tests/test_dyngr.py's TOV at 24^3 for 30 cycles on its own deck
    (f64): the central density within 0.13 of its start on the fixed
    spacetime; within 0.10 coupled to Z4c, the lapse in (0.1, 1.05)."""
    text = test_literal("test_dyngr.py", "TOV")
    z4c = test_literal("test_dyngr.py", "Z4C_BLOCK")
    out = {}
    for label, spacetime, bar in (("fixed", "<adm>", 0.13),
                                  ("coupled", "<adm>" + z4c, 0.10)):
        mesh, _, _, state, _ = run_deck_text(
            torch, text.format(nlim=30, spacetime=spacetime))
        dyn_finite(torch, state, f"tov {label}")
        drift = dyn_density_drift(state["w"])
        rec = {"cycles": mesh.ncycle, "drift": drift}
        if label == "coupled":
            lapse = state["z"][:, 18]
            rec["lapse"] = (float(lapse.min()), float(lapse.max()))
            if not (rec["lapse"][0] > 0.1 and rec["lapse"][1] < 1.05):
                raise AssertionError(f"phase 23 tov coupled: lapse {rec}")
        if not (mesh.ncycle == 30 and drift < bar):
            raise AssertionError(f"phase 23 tov {label}: {rec} (bar {bar})")
        out[label] = rec
    return out


def sod_bar(torch):
    """tests/test_dyngr.py::test_dyngr_shocktube_matches_sr on its own
    deck (f64, 256 cells to t = 0.4): the fixed-Minkowski dyngr density
    within L1 0.005 of the SR MHD tube's, the fan resolved."""
    text = test_literal("test_dyngr.py", "MUB1")
    dyn = test_literal("test_dyngr.py", "DYNGR_COORD")
    sr = test_literal("test_dyngr.py", "SR_COORD")
    rho = {}
    for label, coord in (("dyngr", dyn), ("sr", sr)):
        mesh, _, _, state, _ = run_deck_text(
            torch, text.format(coord=coord, dyn_eos="ideal"))
        rho[label] = state["w"][0, 0, 0, 0, 2:-2].double().cpu()
        rho[f"{label}_cycles"] = mesh.ncycle
    l1 = float((rho["dyngr"] - rho["sr"]).abs().mean())
    out = {"l1": l1, "min": float(rho["dyngr"].min()),
           "max": float(rho["dyngr"].max()),
           "cycles": (rho["dyngr_cycles"], rho["sr_cycles"])}
    if not (bool(torch.isfinite(rho["dyngr"]).all()) and l1 < 0.005
            and out["min"] < 0.13 and out["max"] > 0.9):
        raise AssertionError(f"phase 23 sod bar: {out}")
    return out


def bbh_metric_bar(torch):
    """tests/test_dynbbh.py::test_bbh_metric_structure's minima of the
    lapse on its own deck (f64): the two deepest at (+-10, 0) at t = 0 and
    at (0, +-10) a quarter orbit later, within 2.6; the curvature nonzero
    and every field finite."""
    import numpy as np
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.main import build
    pin = ParameterInput.from_string(test_literal("test_dynbbh.py", "DECK"))
    mesh, phys, _, _, _ = build(pin, device="cuda")
    mbi = mesh.mb_indcs
    out = {}
    for label, t, want in (("t0", 0.0, [(-10.0, 0.0), (10.0, 0.0)]),
                           ("quarter", 0.25 * 2.0 * math.pi
                            / 20.0 ** -1.5, [(0.0, -10.0), (0.0, 10.0)])):
        adm = phys.adm_of({"t": torch.tensor(t, dtype=torch.float64,
                                             device="cuda")})
        fields = adm["g3d"] + adm["beta_u"] + [adm["alpha"]] + adm["K_dd"]
        if not all(bool(torch.isfinite(f).all()) for f in fields):
            raise AssertionError(f"phase 23 bbh metric {label}: non-finite")
        kmax = max(float(f.abs().max()) for f in adm["K_dd"])
        a = adm["alpha"][:, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                         mbi.is_:mbi.ie + 1].cpu().numpy()
        mins = []
        for gid in range(mesh.nmb_total):
            x1v, x2v, _ = mesh.cell_centers(gid)
            k, j, i = np.unravel_index(a[gid].argmin(), a[gid].shape)
            mins.append((a[gid][k, j, i], x1v[mbi.is_ + i],
                         x2v[mbi.js + j]))
        pos = sorted((float(x), float(y)) for _, x, y in sorted(mins)[:2])
        ok = all(abs(x - wx) < 2.6 and abs(y - wy) < 2.6
                 for (x, y), (wx, wy) in zip(pos, sorted(want)))
        out[label] = {"minima": pos, "kmax": kmax}
        if not (ok and kmax > 1e-5):
            raise AssertionError(f"phase 23 bbh metric {label}: {out}")
    return out


def dyn_restart(torch, kernels):
    """tov_cowling as shipped (f64): NCYC_DYN cycles straight against
    half, a .rst, then -r and the other half: u, w, T, bcc and the face
    field bitwise equal."""
    from athenak_tpu_torch import main as cli_main
    n = NCYC_DYN // 2
    deck = DYN_SHIPPED["tov_cowling"]
    common = ["output9/file_type=rst", f"output9/dcycle={n}"]
    cwd = os.getcwd()
    os.environ["ATHENAK_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        try:
            _, _, _, s1 = cli_main.cli([
                "-i", deck, "-d", os.path.join(tmp, "straight"), *common,
                f"time/nlim={2 * n}"])
            os.chdir(cwd)
            cli_main.cli(["-i", deck, "-d", os.path.join(tmp, "first"),
                          *common, f"time/nlim={n}"])
            os.chdir(cwd)
            rst = os.path.join(tmp, "first", "tov_cowling.00001.rst")
            kernels.reset_counts()
            m2, _, _, s2 = cli_main.cli(["-r", rst, "-d",
                                         os.path.join(tmp, "first"),
                                         f"time/nlim={2 * n}"])
            resumed = {k.name: k.launches for k in kernels.ALL if k.launches}
        finally:
            os.chdir(cwd)
    expect23("restart resumed", resumed, {})
    if m2.ncycle != 2 * n:
        raise AssertionError(f"phase 23 restart: {m2.ncycle} cycles")
    for key in ("u", "w", "T", "bcc"):
        if not torch.equal(s1[key], s2[key]):
            raise AssertionError(f"phase 23 restart: {key} not bitwise")
    for c in s1["bfc"]:
        if not torch.equal(s1["bfc"][c], s2["bfc"][c]):
            raise AssertionError(f"phase 23 restart: {c} not bitwise")
    print(f"phase 23: restart tov_cowling (f64): {2 * n} cycles straight "
          f"and {n} + -r {n} bitwise equal (u, w, T, bcc, face field; the "
          f".rst carries T); launches resumed {resumed}")
    return {"resumed": resumed}


def dyn_graph_checks(torch):
    """The CUDA graphs of the dyngr path against the eager calls they
    replay, bitwise: the primitive solver on tov_cowling's state (f64) as
    initialised and perturbed (the capture, then a replay on new
    values), and the Z4c RHS with the matter source on tov_z4c_smr's
    (f64, two levels, coupled)."""
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.main import build
    out = {}
    pin = ParameterInput.from_file(DYN_SHIPPED["tov_cowling"])
    _, phys, _, _, state = build(pin, device="cuda")
    adm = phys.adm_of(state)
    ps = phys.ps
    gen = torch.Generator(device="cuda").manual_seed(23)
    graphed = ps._c2p_graph
    for label, u in (("initial", state["u"]),
                     ("perturbed", state["u"] * (1.0 + 1e-3 * torch.rand(
                         state["u"].shape, generator=gen, device="cuda",
                         dtype=state["u"].dtype)))):
        got = phys.cons_to_prim(u, state["bcc"], adm)
        ps._c2p_graph = ps._con_to_prim
        try:
            ref = phys.cons_to_prim(u, state["bcc"], adm)
        finally:
            ps._c2p_graph = graphed
        same = all(torch.equal(a, b) for a, b in zip(got[:3], ref[:3])) \
            and all(torch.equal(got[3][k], ref[3][k]) for k in ref[3])
        if not same:
            raise AssertionError(f"phase 23 c2p graph {label}: not bitwise "
                                 "the eager solve")
    out["c2p"] = {"captures": graphed.captures, "replays": graphed.replays}
    if out["c2p"] != {"captures": 1, "replays": 2}:
        raise AssertionError(f"phase 23 c2p graph: {out['c2p']}")
    pin = ParameterInput.from_file(DYN_SHIPPED["tov_z4c_smr"])
    _, phys, _, _, state = build(pin, device="cuda")
    tm = phys.set_tmunu(state["u"], state["w"], state["bcc"],
                        phys.adm_of(state))
    z = state["z"]
    for label, zz in (("initial", z), ("perturbed", z * (1.0 + 1e-6 * (
            torch.rand(z.shape, generator=gen, device="cuda",
                       dtype=z.dtype) - 0.5)))):
        got = phys.z4c._matter_rhs(zz, tm)
        ref = phys.z4c.rhs(zz, tmunu=tm)
        if not torch.equal(got, ref):
            raise AssertionError(f"phase 23 Z4c matter RHS graph {label}: "
                                 "not bitwise the eager RHS")
    g = phys.z4c._matter_rhs
    out["z4c_matter_rhs"] = {"captures": g.captures, "replays": g.replays}
    if out["z4c_matter_rhs"] != {"captures": 1, "replays": 2}:
        raise AssertionError(f"phase 23 Z4c matter RHS graph: {out}")
    print(f"phase 23: the CUDA graphs (the primitive solver on "
          f"tov_cowling, the Z4c RHS with matter on tov_z4c_smr; f64) "
          f"bitwise equal to the eager calls, as captured and replayed on "
          f"new values: {out}")
    return out


def dyn_bars(torch, kernels, card):
    """Phase 23's runs that time nothing (the CUDA graphs' checks, the
    shipped decks, the JAX tests' bars, the restart); they run in
    lanes (``LANES``)."""
    seconds = {}

    def part(label, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        seconds[label] = time.perf_counter() - t
        return res

    graphs = part("graphs", dyn_graph_checks, torch)
    shipped = part("shipped", dyn_shipped, torch, kernels, card)
    bars = {"tov": part("tov_bars", tov_bars, torch),
            "sod_vs_sr": part("sod_bar", sod_bar, torch),
            "bbh_metric": part("bbh_metric_bar", bbh_metric_bar, torch)}
    restart = part("restart", dyn_restart, torch, kernels)
    print(f"phase 23: [{card}] the JAX tests' bars on the card {bars}")
    return {"shipped": shipped, "bars": bars, "restart": restart,
            "graphs": graphs, "seconds": seconds}


def dyn_stage_parts(torch, phys, state, driver):
    """ms (events) of the parts of a stage of the coupled dyngr deck on
    its state: the fluxes, the coordinate sources, Tmunu, the Z4c RHS
    with the matter source, the fills of u, the faces and z, the c2p
    (with the ADM refresh), one whole stage and one whole cycle; and the
    device launches of one stage (``torch.profiler``; None where it
    records no device time)."""
    dt = driver.mesh.dt
    u, w, T, bcc, bfc, z = (state[k] for k in ("u", "w", "T", "bcc", "bfc",
                                               "z"))
    saved = phys.save_state(state)
    adm = phys.adm_of(state)
    tm = phys.set_tmunu(u, w, bcc, adm)
    cycle = driver.make_cycle_fn()

    def fills():
        phys.bvals.fill_ghosts(u.clone())
        phys.fill_ghosts_fc({k: v.clone() for k, v in bfc.items()})
        phys.bvals.fill_ghosts(z.clone())

    def stage():
        return phys.stage_update(state, saved, 0.0, 1.0, dt)

    parts = {
        "fluxes": cuda_ms(lambda: phys.fluxes(w, T, bcc, bfc, adm), 3),
        "coord_src": cuda_ms(lambda: phys.coord_src_terms(
            u.clone(), w, T, bcc, adm, dt), 3),
        "tmunu": cuda_ms(lambda: phys.set_tmunu(u, w, bcc, adm), 3),
        "z4c_rhs_matter": cuda_ms(lambda: phys.z4c.rhs(z, tmunu=tm), 3),
        "fills u+faces+z": cuda_ms(fills, 3),
        "clones u+faces+z": cuda_ms(lambda: (
            u.clone(), {k: v.clone() for k, v in bfc.items()}, z.clone()),
            3),
        "c2p (adm + c2p)": cuda_ms(lambda: phys.cons_to_prim(
            u, bcc, phys.adm_of(state)), 3),
        "stage": cuda_ms(stage, 3),
        "cycle": cuda_ms(lambda: cycle(state, dt), 2)}
    return parts, split_launches(device_split(torch, stage, 1), 1)


def phase_dyn_wide(torch, kernels, card):
    """DYN_WIDE: tov_z4c_smr at 64^3 in 32^3 blocks (64 blocks on level
    1, 2.1 M cells, f32, coupled Z4c) through the CLI for NCYC_DYN_WIDE
    cycles on both paths (``mhd/use_kernels``): no launch (outflow
    sides close B and G, the matter closes H), the paths bitwise equal,
    the state finite with the lapse in (0, 1], peak memory; the ms of a
    stage's parts and its device launches; both paths' zone-cycles/s in
    turns (CUDA events, NCYC_DYN_WIDE cycles after a warm-up)."""
    deck = DYN_SHIPPED["tov_z4c_smr"]
    n = NCYC_DYN_WIDE
    out, states, runs = {}, {}, {}
    for use in ("true", "false"):
        torch.cuda.reset_peak_memory_stats()
        got, mesh, phys, driver, state, _ = grav_cli(
            torch, kernels, deck, DYN_WIDE + [f"mhd/use_kernels={use}"], n)
        expect23(f"dyn_wide {use}", got, {})
        dyn_finite(torch, state, "dyn_wide")
        lapse = state["z"][:, 18]
        if not (float(lapse.min()) > 0.0 and float(lapse.max()) <= 1.0):
            raise AssertionError("phase 23 dyn_wide: lapse out of (0, 1]")
        div = check_levels(torch, mesh, state, "phase 23 dyn_wide")
        states[use] = state
        runs[use] = (phys, driver)
        out[f"dyn_wide {use}"] = {
            "launches": got, "zcps": driver.zcps, "div_b": div,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        mbi = mesh.mb_indcs
        print(f"phase 23: dyn_wide use_kernels={use}: {mesh.nmb_total} "
              f"blocks of {mbi.nx1}^3 on levels "
              f"{sorted(set(int(v) for v in mesh.mb_lev))}, {n} cycles, "
              f"launches {got}, peak memory "
              f"{out[f'dyn_wide {use}']['peak_gib']:.2f} GiB; [{card}] CLI "
              f"zone-cycles/s {driver.zcps:.6e} (wall clock)")
    for k in ("u", "w", "T", "z"):
        if not torch.equal(states["true"][k], states["false"][k]):
            raise AssertionError(f"phase 23 dyn_wide: {k} differs between "
                                 "the paths")
    parts, launches = dyn_stage_parts(torch, *runs["true"][:1],
                                      states["true"], runs["true"][1])
    del states, state, runs
    torch.cuda.empty_cache()
    rates = {"true": [], "false": []}
    for use in ("true", "false", "true", "false"):
        rates[use].append(timed_cycles(torch, use, deck, n, DYN_WIDE,
                                       "mhd"))
    out["dyn_wide"] = {"parts_ms": parts, "stage_launches": launches,
                       "rates": rates}
    print(f"phase 23: [{card}] dyn_wide: ms of a stage's parts {parts}; "
          f"device launches a stage {launches}; zone-cycles/s in turns "
          f"(events, {n} cycles after a warm-up) {rates}")
    return out


# ------------------------------------------------------------ the lanes
# The runs that time nothing (the JAX tests' bars, the restarts, the
# Bonnor-Ebert runs, phase 23's shipped decks and graph checks) run in
# child processes on the card (``chip_smoke.py --lane NAME...``), one a
# lane, started once the kernels' and DYN_WIDE's timings are done; the
# main process drives phases 13-22 beside them.  Most are launch-bound,
# and launch-bound processes hardly slow each other on the card (four
# copies of the linear wave: 1.08-1.15x, prof_dyn_graphs.py); the
# longest lane holds the 64-cell linear wave's 5,647 cycles.
# ---------------------------------------------------------------------------
# phase 24: the block axis split over the ranks of a process group
NCYC_SHARD = 10
NCYC_SHARD_AMR = 20
# one_puncture.athinput as 8 flat blocks of 64^3, float32
Z4C_SHARD = ["job/precision=single", "mesh/nx1=128", "mesh/nx2=128",
             "mesh/nx3=128", "meshblock/nx1=64", "meshblock/nx2=64",
             "meshblock/nx3=64"]
# turb8 on 4 ranks against one rank: the driver's volume integrals are
# all-reduced in another order (test_turb_shard.py holds float64 to
# 1e-10); float32 here, of the field's scale
SHARD_TURB_TOL = 1e-5
SHARD_TIMEOUT = 600
# the stage kernels each rank launches once a stage, as one rank does;
# the fills' kernels G and I close on one rank's blocks of a group
SHARD_STAGE_KERNELS = ("mega_stage_v2", "mega_stage_v1", "fused_aux3d",
                       "fused_flux_dir", "z4c_stage")
SHARD_CLOSED = ("pool_fill", "z4c_outflow_fill")


def shard_jobs(tmp):
    """(label, deck, overrides, cycles, ranks) of phase 24's checks."""
    pool = os.path.join(tmp, "pool.athinput")
    turb = os.path.join(tmp, "turb.athinput")
    for path, text in ((pool, POOL_DECK), (turb, TURB_DECK)):
        with open(path, "w") as f:
            f.write(text)
    return [("pool", pool, [], NCYC_SHARD, 2),
            ("pool", pool, [], NCYC_SHARD, 4),
            ("smr", SMR_DECK, ["job/precision=single", *SMR_FULL],
             NCYC_SHARD, 4),
            ("z4c", PUNCTURE, Z4C_SHARD, NCYC_SHARD, 4),
            ("turb8", turb, TURB8, NCYC_SHARD, 4),
            ("blast_amr", BLAST_AMR, AMR_NOPOOL, NCYC_SHARD_AMR, 4)]


def leaf_digests(state, prefix=""):
    """SHA-256 of the bytes of every tensor of a state, by path."""
    import hashlib
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(leaf_digests(v, f"{prefix}{k}/"))
        elif hasattr(v, "detach"):
            a = v.detach().cpu().contiguous().numpy()
            out[prefix + k] = hashlib.sha256(a.tobytes()).hexdigest()
    return out


def shard_job(torch, kernels, ranks, deck, extra, ncyc, keep=()):
    """One deck through ``main.run`` on ``ranks`` (None: no group), the
    launch counts set to 0 just before and read just after.  Returns the
    launches and, where the whole state is (one rank, or rank 0), its
    digests, the time, cycles, floor counts, the trees, the history file
    and the leaves named in ``keep`` (numpy)."""
    from athenak_tpu_torch.driver import Driver
    from athenak_tpu_torch.main import run
    pin = pin_for(list(extra) + [f"time/nlim={ncyc}"], deck)
    cwd = os.getcwd()
    # the gravity solves of the run's cycles (the generator's final
    # report solves again, on rank 0 alone)
    made = {}
    execute = Driver.execute

    def counted(self, *args, **kw):
        out = execute(self, *args, **kw)
        made["solves"] = solves(self)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        Driver.execute = counted
        try:
            mesh, phys, driver, state = run(pin, device="cuda", ranks=ranks)
            launches = {k.name: k.launches for k in kernels.ALL}
            hst = {f: open(f).read() for f in sorted(os.listdir("."))
                   if f.endswith(".hst")}
        finally:
            Driver.execute = execute
            os.chdir(cwd)
    rec = {"launches": launches, "solves": made["solves"],
           # a captured window solves once more in its warm-up cycle
           "captured": bool(driver.window and driver.window["captures"]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if state is None:
        return rec
    rec.update(digests=leaf_digests(state), time=mesh.time,
               ncycle=mesh.ncycle, ecounters=driver.ecounters, hst=hst,
               nmb=mesh.nmb_total,
               keep={k: state[k].detach().cpu().numpy() for k in keep})
    if driver.pamr is not None:
        rec.update(trees=[u["leaves"] for u in driver.pamr.updates],
                   created=driver.pamr.nmb_created,
                   deleted=driver.pamr.nmb_deleted)
    if ranks is not None:
        lay = driver._layout
        rec["layout"] = {"blocks_a_rank": lay.nmb_eachrank.tolist(),
                         "L": lay.L, "uniform": lay.uniform}
    return rec


def solves(driver):
    """[solves, V-cycles] of the driver's gravity solver ([0, 0] without
    one; the FFT takes no V-cycles)."""
    pg = getattr(driver.phys, "pgrav", None)
    return [getattr(pg, "nsolve", 0), getattr(pg, "ncycles", 0)]


def shard_timed(torch, ranks, deck, extra, ncyc):
    """zone-cycles/s of ``ncyc`` cycles after a warm-up cycle (CUDA
    events), and under ``ranks`` the bytes this rank sends a fill of u
    and the ms of that fill (five fills after one)."""
    from athenak_tpu_torch.comm import use_comm
    from athenak_tpu_torch.main import build
    mesh, phys, _, driver, state = build(pin_for(list(extra), deck),
                                         device="cuda")
    driver.ranks = ranks
    state = driver.initialize(state)
    cycle = driver._build_cycle()
    dt = mesh.dt
    state, dtnew, _ = cycle(state, dt)
    dt = min(2.0 * dt, driver.cfl_no * float(dtnew))
    if ranks is not None:
        ranks.barrier()
        b0, g0 = ranks.sent_bytes, ranks.gathered_bytes
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(ncyc):
        state, dtnew, _ = cycle(state, dt)
        dt = min(2.0 * dt, driver.cfl_no * float(dtnew))
    t1.record()
    torch.cuda.synchronize()
    sec = t0.elapsed_time(t1) / 1e3
    mbi = mesh.mb_indcs
    rec = {"sec": sec, "zcps": ncyc * mesh.nmb_total * mbi.nx1 * mbi.nx2
           * mbi.nx3 / sec}
    if ranks is not None:
        # the bytes this rank sent a cycle: point to point (the slab
        # exchange) and into all-gathers (a whole-mesh solve's source)
        rec.update(cycle_sent_bytes=(ranks.sent_bytes - b0) / ncyc,
                   cycle_gathered_bytes=(ranks.gathered_bytes - g0) / ncyc)
        u = state["u"].clone()
        with use_comm(driver.comm):
            phys.bvals.fill_ghosts(u)
            torch.cuda.synchronize()
            b0, e0 = ranks.sent_bytes, ranks.exchanges
            t = time.perf_counter()
            for _ in range(5):
                phys.bvals.fill_ghosts(u)
            torch.cuda.synchronize()
        rec.update(fill_ms=1e3 * (time.perf_counter() - t) / 5,
                   fill_bytes=(ranks.sent_bytes - b0) // 5,
                   fill_exchanges=(ranks.exchanges - e0) // 5)
        # one all-gather of the density of every block (what a gravity
        # solve reads first, ``comm.whole_blocks``): five after one
        rho = state["u"][:, :1].contiguous()
        driver.comm.whole_blocks(rho)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            driver.comm.whole_blocks(rho)
        torch.cuda.synchronize()
        rec["gather_ms"] = 1e3 * (time.perf_counter() - t) / 5
    return rec


#: what each rank reports of a timed run (``shard_timed``)
TIMED_KEYS = ("sec", "fill_ms", "fill_bytes", "fill_exchanges",
              "cycle_sent_bytes", "cycle_gathered_bytes", "gather_ms")


def shard_rank(ranks, jobs, timed=False):
    """A rank of phase 24: each job on the group of its first ranks,
    in turn.  Rank 0 returns the results by "label ranks", with every
    rank's launches (or timings)."""
    import torch
    from athenak_tpu_torch import kernels
    os.environ["ATHENAK_DEVICE"] = "cuda"
    out = {}
    for label, deck, extra, ncyc, world in jobs:
        sub = ranks.sub(world)
        if sub is None:
            continue
        if timed:
            rec = shard_timed(torch, sub, deck, extra, ncyc)
            row = [rec[k] for k in TIMED_KEYS]
        else:
            rec = shard_job(torch, kernels, sub, deck, extra, ncyc,
                            keep=("u",) if label == "turb8" else ())
            row = [rec["launches"][k.name] for k in kernels.ALL] \
                + rec["solves"] + [rec["peak_gib"]]
        rows = sub.all_gather(torch.tensor([row], dtype=torch.float64,
                                           device=sub.device)).tolist()
        if sub.rank == 0:
            if timed:
                rec["by_rank"] = [dict(zip(TIMED_KEYS, r)) for r in rows]
            else:
                rec["launches_by_rank"] = [
                    {k.name: int(v) for k, v in zip(kernels.ALL, r)}
                    for r in rows]
                rec["solves_by_rank"] = [[int(v) for v in r[-3:-1]]
                                         for r in rows]
                rec["peak_gib_by_rank"] = [r[-1] for r in rows]
            out[f"{label} {world}"] = rec
    return out if ranks.rank == 0 else None


def shard_checks(torch, kernels, card):
    """Phase 24's checks (a lane): every job of ``shard_jobs`` on its
    ranks (gloo, all on cuda:0) against its one-rank run here."""
    from athenak_tpu_torch.parallel import spawn_ranks
    kernels.library()   # built here, before the ranks load it
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = shard_jobs(tmp)
        refs = {}
        for label, deck, extra, ncyc, _ in jobs:
            if label not in refs:
                refs[label] = shard_job(
                    torch, kernels, None, deck, extra, ncyc,
                    keep=("u",) if label == "turb8" else ())
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"phase 24: [{card}] {free / 2**30:.1f} GiB of "
              f"{total / 2**30:.1f} free on the card as the ranks start",
              flush=True)
        t = time.perf_counter()
        got = spawn_ranks("chip_smoke:shard_rank", 4, backend="gloo",
                          device="cuda", args=(jobs,),
                          timeout=SHARD_TIMEOUT)[0]
        out["spawn_seconds"] = time.perf_counter() - t
    for label, deck, extra, ncyc, world in jobs:
        out[f"{label} on {world} ranks"] = shard_compare(
            label, refs[label], got[f"{label} {world}"], ncyc, world, card)
    return out


def shard_compare(label, ref, rec, ncyc, world, card, backend="gloo",
                  stage=True, phase="24"):
    """Hold phase 24's (or 27's) split run ``rec`` of a deck to its
    one-rank run ``ref``: the cycles, the state bitwise (turb8: within
    SHARD_TURB_TOL of its scale), time, counters, history, trees, every
    rank's gravity solves and V-cycles equal to each other's and to one
    rank's (its graph's warm-up cycle solves too), and every
    rank's launches as derived (each stage kernel as often as on one
    rank, the fills' kernels G and I never; with ``stage`` a stage
    kernel must have run).  Prints and returns the record."""
    name = f"{label} on {world} ranks ({backend})"
    if rec["ncycle"] != ncyc or ref["ncycle"] != ncyc:
        raise AssertionError(f"phase {phase} {name}: {rec['ncycle']} and "
                             f"{ref['ncycle']} cycles, {ncyc} asked")
    if label == "turb8":
        u, u0 = rec["keep"]["u"], ref["keep"]["u"]
        err = float(abs(u - u0).max()) / float(abs(u0).max())
        if not err <= SHARD_TURB_TOL:
            raise AssertionError(f"phase {phase} {name}: u {err:g} of its "
                                 f"scale from one rank > "
                                 f"{SHARD_TURB_TOL}")
        diff = err
    else:
        bad = [k for k in ref["digests"]
               if rec["digests"].get(k) != ref["digests"][k]]
        if bad or rec["time"] != ref["time"] \
                or rec["ecounters"] != ref["ecounters"] \
                or rec["hst"] != ref["hst"]:
            raise AssertionError(
                f"phase {phase} {name}: not bitwise one rank's: leaves "
                f"{bad}, time {rec['time']!r} / {ref['time']!r}, "
                f"counters {rec['ecounters']} / {ref['ecounters']}")
        diff = 0.0
    if "trees" in ref and (rec["trees"] != ref["trees"]
                           or rec["created"] != ref["created"]
                           or rec["deleted"] != ref["deleted"]):
        raise AssertionError(f"phase {phase} {name}: other trees than one "
                             "rank's")
    # launches per rank as derived: each stage kernel as often as on
    # one rank, the fills' kernels G and I never
    one = ref["launches"]
    for r, lr in enumerate(rec["launches_by_rank"]):
        for k in SHARD_STAGE_KERNELS:
            if lr[k] != one[k]:
                raise AssertionError(
                    f"phase {phase} {name}: rank {r} launched {k} "
                    f"{lr[k]} times, one rank {one[k]}")
        for k in SHARD_CLOSED:
            if lr[k] != 0:
                raise AssertionError(f"phase {phase} {name}: rank {r} "
                                     f"launched {k} {lr[k]} times")
    # every rank solves alike; as often as one rank, whose window, where
    # a graph captured it, solved in its warm-up cycle too
    sv = rec["solves_by_rank"]
    if any(v != sv[0] for v in sv) or sv[0][1] != ref["solves"][1] or (
            sv[0][0] != ref["solves"][0] and not ref["captured"]):
        raise AssertionError(f"phase {phase} {name}: [solves, V-cycles] "
                             f"a rank {sv}, one rank {ref['solves']}")
    if stage and not any(one[k] for k in SHARD_STAGE_KERNELS):
        raise AssertionError(f"phase {phase} {name}: no stage kernel ran")
    out = {"max_rel_diff": diff,
           "layout": rec["layout"],
           "one_rank_launches": {k: v for k, v in one.items() if v},
           "launches_by_rank": [{k: v for k, v in lr.items() if v}
                                for lr in rec["launches_by_rank"]],
           "trees": len(ref.get("trees", [])),
           "solves": ref["solves"],
           "peak_gib_a_rank": rec["peak_gib_by_rank"]}
    print(f"phase {phase}: [{card}] {name}: "
          + ("bitwise one rank's" if label != "turb8" else
             f"u within {diff:.3g} of its scale")
          + f", launches a rank {out['launches_by_rank']}, one "
          f"rank {out['one_rank_launches']}", flush=True)
    return out


def phase_shard(torch, kernels, card):
    """Phase 24's timings (main process): the pool deck on 1, 2 and 4
    ranks under gloo on this card, and on one rank a card under nccl
    where there are cards enough; there also the Z4c deck and RAD_POOL
    under nccl against one rank (their dt is a host number, which each
    rank all-reduces on its card)."""
    from athenak_tpu_torch.parallel import spawn_ranks
    kernels.library()   # built here, before the ranks load it
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        pool = os.path.join(tmp, "pool.athinput")
        with open(pool, "w") as f:
            f.write(POOL_DECK)
        one = shard_timed(torch, None, pool, [], NCYC_SHARD)
        out["gloo 1"] = {"zcps": one["zcps"]}
        jobs = [("pool", pool, [], NCYC_SHARD, 2),
                ("pool", pool, [], NCYC_SHARD, 4)]
        # shard_rank's keys are "pool <ranks>"
        got = {f"gloo {k.split()[1]}": v for k, v in spawn_ranks(
            "chip_smoke:shard_rank", 4, backend="gloo", device="cuda",
            args=(jobs, True), timeout=SHARD_TIMEOUT)[0].items()}
        backends = ["gloo (all ranks on cuda:0, host-staged)"]
        ncard = torch.cuda.device_count()
        if ncard >= 2:
            nj = [j for j in jobs if j[4] <= ncard]
            got.update({f"nccl {k.split()[1]}": v for k, v in spawn_ranks(
                "chip_smoke:shard_rank", max(j[4] for j in nj),
                backend="nccl", args=(nj, True),
                timeout=SHARD_TIMEOUT)[0].items()})
            backends.append("nccl (one rank a card)")
            nw = min(ncard, 4)
            cj = [("z4c", PUNCTURE, Z4C_SHARD, NCYC_SHARD, nw),
                  ("rad", RAD_LINWAVE, RAD_POOL, NCYC_RAD, nw)]
            recs = spawn_ranks("chip_smoke:shard_rank", nw, backend="nccl",
                               args=(cj,), timeout=SHARD_TIMEOUT)[0]
            checks = {}
            for label, deck, extra, ncyc, world in cj:
                ref = shard_job(torch, kernels, None, deck, extra, ncyc)
                # RAD_POOL's one kernel on one rank is G, which closes
                checks[f"{label} on {world} ranks"] = shard_compare(
                    label, ref, recs[f"{label} {world}"], ncyc, world,
                    card, backend="nccl", stage=label != "rad")
                torch.cuda.empty_cache()
    for name, rec in got.items():
        # the rate of the slowest rank's cycles
        slow = max(r["sec"] for r in rec["by_rank"])
        zc = rec["zcps"] * rec["sec"] / slow
        out[name] = {"zcps": zc,
                     "fill_bytes_a_rank": [int(r["fill_bytes"])
                                           for r in rec["by_rank"]],
                     "fill_ms_a_rank": [r["fill_ms"]
                                        for r in rec["by_rank"]],
                     "exchange_ms_a_rank": [r["fill_ms"] / r["fill_exchanges"]
                                            for r in rec["by_rank"]]}
    print(f"phase 24: [{card}] backends run: {backends}"
          + ("" if len(backends) > 1 else "; nccl not run: "
             f"{torch.cuda.device_count()} card(s)"))
    for name, rec in out.items():
        extra = "" if "fill_ms_a_rank" not in rec else (
            f", bytes a rank sends a fill of u {rec['fill_bytes_a_rank']}"
            f", ms of that fill {[round(x, 3) for x in rec['fill_ms_a_rank']]}"
            f", ms an exchange "
            f"{[round(x, 3) for x in rec['exchange_ms_a_rank']]}")
        print(f"phase 24: [{card}] pool 8 x 62^3 on {name} rank(s): "
              f"{rec['zcps']:.4g} zone-cycles/s{extra}")
    if ncard >= 2:
        out["nccl_checks"] = checks
    return out


# ---------------------------------------------------------------------------
# phase 25: the output tail on the card (the derived-variable registry,
# cbin, pdf, cartgrid, sphsurf, log and -p)
NCYC_OUT = NCYC              # the blast, 20 cycles as phase 4
NCYC_OUT_DECK = 10
OUT_EVERY = 5                # cycles between the grid outputs' writes
# a pdf of the kernel path may move at most this share of its weight
# between bins against the plain path's (the paths' cells differ at the
# tiers of SMR_PATH_TOL, so cells next to a bin edge may change bins);
# the bins put no edge at the ambient density 1 or field 0.1
PDF_PATH_TOL = 1e-3
# the invariants: float64 sums of float32 cells (pdf weights, prtcl_d),
# float32 payloads (sphsurf weights, cbin means, cartgrid values)
OUT_SUM_TOL = 1e-6
OUT_F32_TOL = 1e-6
# the families of the state itself (and their resamplings): the paths'
# tolerance; the derived variables (curvature divides by B^2 and
# differences the field's unit vector, the SGS moments are cubic) amplify
# the state's difference: their loose tier is ten times the state's
OUT_STATE_VARS = ("mhd_w", "mhd_u", "mhd_w_bcc", "mhd_u_bcc", "mhd_bcc",
                  "turb_force", "prtcl_d")
DERIVED_PATH_TOL = (SMR_PATH_TOL[0], 10 * SMR_PATH_TOL[1])
OUT_BINS = ("mhd_divb", "mhd_j2", "mhd_curv", "mhd_sgs")


def out_blocks(specs, first=2):
    """<outputN>/key=value overrides of ``specs`` (dicts), from
    <output``first``> on."""
    return [f"output{n}/{k}={v}" for n, spec in enumerate(specs, first)
            for k, v in spec.items()]


OUT_BLAST = out_blocks(
    [{"file_type": "bin", "variable": v} for v in OUT_BINS]
    + [{"file_type": "cbin", "variable": "mhd_w_bcc", "coarsen_factor": 4,
        "compute_moments": "true", "dcycle": OUT_EVERY},
       {"file_type": "pdf", "variable": "mhd_w_d", "mass_weighted": "true",
        "bin_min": 0.01, "bin_max": 100.0, "nbin": 39,
        "dcycle": OUT_EVERY},
       {"file_type": "pdf", "variable": "mhd_w_d", "variable_2": "mhd_bmag",
        "bin_min": 0.01, "bin_max": 100.0, "nbin": 39, "bin2_min": 1e-3,
        "bin2_max": 10.0, "nbin2": 19, "dcycle": OUT_EVERY},
       {"file_type": "cartgrid", "variable": "mhd_w", "chebyshev": "true",
        "extent_x": 0.9, "extent_y": 0.9, "extent_z": 0.9,
        "dcycle": OUT_EVERY},
       {"file_type": "sphsurf", "variable": "mhd_w_bcc", "nradii": 4,
        "r_min": 0.1, "r_max": 0.8, "r_spacing": "log",
        "dcycle": OUT_EVERY},
       {"file_type": "log", "dcycle": OUT_EVERY}])
OUT_POOL = out_blocks(
    [{"file_type": "cbin", "variable": "mhd_w_bcc", "coarsen_factor": 2,
      "compute_moments": "true", "dcycle": OUT_EVERY},
     {"file_type": "bin", "variable": "mhd_w_bcc"}])
OUT_SPLIT = out_blocks(
    [{"file_type": "cbin", "variable": "mhd_w_bcc", "coarsen_factor": 2,
      "dcycle": OUT_EVERY},
     {"file_type": "pdf", "variable": "mhd_w_d", "bin_min": 0.01,
      "bin_max": 100.0, "nbin": 39, "variable_2": "mhd_bmag",
      "bin2_min": 1e-3, "bin2_max": 10.0, "nbin2": 19,
      "dcycle": OUT_EVERY},
     {"file_type": "bin", "variable": "mhd_jcon", "dcycle": OUT_EVERY}])
OUT_SMR = out_blocks(
    [{"file_type": "cartgrid", "variable": "mhd_w", "extent_x": 0.9,
      "extent_y": 0.9, "extent_z": 0.9, "dcycle": OUT_EVERY},
     {"file_type": "sphsurf", "variable": "mhd_w_bcc", "nradii": 4,
      "r_min": 0.1, "r_max": 0.8, "dcycle": OUT_EVERY},
     {"file_type": "bin", "variable": "mhd_divb"}])
OUT_TURB = out_blocks([{"file_type": "bin", "variable": "turb_force"}])
OUT_PART = out_blocks([{"file_type": "bin", "variable": "prtcl_d"}])
OUT_PROFILE_CYCLES = 3


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def out_decks(tmp):
    """label -> (deck, overrides, cycles, the new outputs) of phase 25."""
    paths = {}
    with open(DECK) as f:
        part = f.read() + "\n" + particles_block()
    for name, text in (("pool", POOL_DECK), ("turb", TURB_DECK),
                       ("part_blast", part)):
        paths[name] = os.path.join(tmp, f"{name}.athinput")
        with open(paths[name], "w") as f:
            f.write(text)
    return {"blast": (DECK, [], NCYC_OUT, OUT_BLAST),
            "pool": (paths["pool"], [], NCYC_OUT_DECK, OUT_POOL),
            "smr": (SMR_DECK, ["job/precision=single", *SMR_FULL],
                    NCYC_OUT_DECK, OUT_SMR),
            "turb1": (paths["turb"], [], NCYC_OUT_DECK, OUT_TURB),
            "part_blast": (paths["part_blast"], [], NCYC_OUT_DECK,
                           OUT_PART)}


class OutputClock:
    """Within the context: the host seconds and calls of every output
    class's ``write`` and of ``MHD.unpack_state``, the card synchronised
    around each."""

    def __init__(self, torch):
        from athenak_tpu_torch import outputs
        from athenak_tpu_torch.physics.mhd import MHD
        self.torch = torch
        self.targets = [(cls, "write") for cls in set(outputs._TYPES.values())
                        if "write" in cls.__dict__]
        self.targets.append((MHD, "unpack_state"))
        self.seconds, self.calls, self._saved = {}, {}, []

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            _sync(self.torch)
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _sync(self.torch)
                self.seconds[name] = self.seconds.get(name, 0.0) \
                    + time.perf_counter() - t
                self.calls[name] = self.calls.get(name, 0) + 1
        return timed

    def __enter__(self):
        for cls, attr in self.targets:
            fn = cls.__dict__[attr]
            self._saved.append((cls, attr, fn))
            setattr(cls, attr, self._wrap(
                "unpack" if attr == "unpack_state" else cls.__name__, fn))
        return self

    def __exit__(self, *exc):
        for cls, attr, fn in self._saved:
            setattr(cls, attr, fn)


def out_cli(torch, kernels, deck, extra, ncyc, rundir):
    """``main.cli`` on ``deck`` in ``rundir`` for ``ncyc`` cycles, the
    launch counts set to 0 just before and read just after, under an
    ``OutputClock``: (launches, mesh, phys, driver, state, clock, the
    seconds of the call)."""
    from athenak_tpu_torch import main as cli_main
    cwd = os.getcwd()
    kernels.reset_counts()
    with OutputClock(torch) as clock:
        t = time.perf_counter()
        try:
            mesh, phys, driver, state = cli_main.cli(
                ["-i", deck, "-d", rundir, f"time/nlim={ncyc}", *extra])
        finally:
            os.chdir(cwd)
        _sync(torch)
        sec = time.perf_counter() - t
    launches = {k.name: k.launches for k in kernels.ALL}
    if mesh.ncycle != ncyc:
        raise AssertionError(f"phase 25 {deck}: {mesh.ncycle} cycles, "
                             f"{ncyc} asked")
    if not bool(torch.isfinite(state["u"]).all()):
        raise AssertionError(f"phase 25 {deck} {extra}: non-finite state")
    return launches, mesh, phys, driver, state, clock, sec


def unpack_launches(torch, kernels, deck, extra):
    """The launches of one ``unpack_state`` of a kernel-path state after
    initialisation: the fills an output's unpack costs."""
    from athenak_tpu_torch.main import build
    _, phys, _, driver, state = build(pin_for(list(extra), deck))
    state = driver.initialize(state)
    _sync(torch)
    kernels.reset_counts()
    phys.unpack_state(state)
    _sync(torch)
    return {k.name: k.launches for k in kernels.ALL}


# -- the files -------------------------------------------------------------
def out_listing(root):
    """Every file under ``root`` by its relative path."""
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


def read_cart(path):
    """A ``cartgrid`` file: (cycle, labels, float32 [nvar, nz, ny, nx])."""
    import struct
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    head = struct.calcsize("=if3f3f3i?3xi")
    vals = struct.unpack("=if3f3f3i?3xi", data[:head])
    npts, nvar = vals[8:11], vals[12]
    ln, = struct.unpack("=i", data[head:head + 4])
    labels = data[head + 4:head + 4 + ln].decode().split()
    arr = np.frombuffer(data[head + 4 + ln:], dtype=np.float32)
    return vals[0], labels, arr.reshape(nvar, npts[2], npts[1], npts[0])


def read_sph(path):
    """A ``sphsurf`` file: (cycle, radii, weights [nang, nrad], labels ->
    [nang, nrad]), its big-endian records as float64."""
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    dims = re.search(rb"DIMENSIONS (\d+) (\d+) (\d+)\n", data)
    nrad, nt, nph = (int(x) for x in dims.groups())
    npts = nrad * nt * nph
    cyc = int(re.search(rb" cycle=(\d+)", data).group(1))
    i = data.index(b"RADII 1 ") + data[data.index(b"RADII 1 "):].index(
        b"\n") + 1
    radii = np.frombuffer(data[i:i + 4 * nrad], ">f4").astype(np.float64)
    recs = {}
    for m in re.finditer(rb"SCALARS (\S+) float 1\nLOOKUP_TABLE default\n",
                         data):
        recs[m.group(1).decode()] = np.frombuffer(
            data[m.end():m.end() + 4 * npts], ">f4").astype(
            np.float64).reshape(nt * nph, nrad)
    return cyc, radii, recs.pop("weights"), recs


def read_pdf(path):
    import numpy as np
    return np.atleast_2d(np.loadtxt(path))


def out_arrays(path):
    """(cycle, labels -> float64 array) of a file of phase 25: bin and
    cbin by ``vis.readers.read_binary``, cartgrid, sphsurf (weights
    under "weights"), pdf (the table under "pdf")."""
    import numpy as np
    from athenak_tpu_torch.vis.readers import read_binary
    if path.endswith(".pdf"):
        return None, {"pdf": read_pdf(path)}
    if os.sep + "cart" + os.sep in path:
        cyc, labels, arr = read_cart(path)
        return cyc, {lab: arr[n].astype(np.float64)
                     for n, lab in enumerate(labels)}
    if os.sep + "sph" + os.sep in path:
        cyc, _, wts, recs = read_sph(path)
        return cyc, dict(recs, weights=wts)
    f = read_binary(path)
    return f["cycle"], {k: v.astype(np.float64)
                        for k, v in f["mb_data"].items()}


def tiers(got, ref, scale):
    """(share of finite cells within SMR_PATH_TOL[0], max) of
    |got - ref| over ``scale``; NaN masks must be equal."""
    import numpy as np
    if not np.array_equal(np.isnan(got), np.isnan(ref)):
        return 0.0, float("inf")
    fin = np.isfinite(ref)
    if not fin.any():
        return 1.0, 0.0
    rel = np.abs(got[fin] - ref[fin]) / scale
    return float((rel < SMR_PATH_TOL[0]).mean()), float(rel.max())


def file_variable(name):
    """The output variable in a file name of phase 25."""
    m = re.search(r"\.([A-Za-z]\w*)\.\d{5}\.\w+$", name)
    return m.group(1) if m else None


def file_scale(ref, ref0):
    """The largest change of any channel of a file from the first file of
    its name (the scale ``change_diff`` takes for u), or its largest
    value where nothing changed."""
    import numpy as np
    scale = 0.0
    for k in ref:
        fin = np.isfinite(ref[k]) & np.isfinite(ref0[k])
        if fin.any():
            scale = max(scale, float(np.abs(ref[k][fin]
                                            - ref0[k][fin]).max()))
    if scale == 0.0:
        scale = max(float(np.nanmax(np.abs(v))) if v.size else 0.0
                    for v in ref.values())
    return max(scale, 1e-30)


def compare_logs(kp, pp):
    """Two paths' ``log`` files: the same columns, cycles and counters,
    the times within dtmin's rtol of 1e-4 (each path has its own dt
    chain)."""
    a = open(kp).read().splitlines()
    b = open(pp).read().splitlines()
    if a[0] != b[0] or len(a) != len(b):
        return False
    for x, y in zip(a[1:], b[1:]):
        x, y = x.split(), y.split()
        if x[1:] != y[1:] or abs(float(x[0]) - float(y[0])) \
                > 1e-4 * abs(float(y[0])):
            return False
    return True


def compare_paths(label, kdir, pdir):
    """The kernel path's files against the plain path's: the same names;
    a ``log`` with the same cycles and counters; a pdf within
    PDF_PATH_TOL of its weight; every other file within SMR_PATH_TOL's
    tiers of the largest change of its channels from its first file of
    the same name (``file_scale``, the scale phases 16 and 21 hold u
    to); a derived variable's within DERIVED_PATH_TOL (``mhd_divb`` is
    round-off: ``out_invariants`` bounds it).  NaN masks equal.  Returns
    (per-file record, failures)."""
    import numpy as np
    names = out_listing(kdir)
    if names != out_listing(pdir):
        return {}, [f"{label}: the paths wrote other files: "
                    f"{sorted(set(names) ^ set(out_listing(pdir)))}"]
    rec, bad = {}, []
    firsts = {}
    for name in names:
        firsts.setdefault(re.sub(r"\.\d{5}\.", ".", name), name)
    for name in names:
        kp, pp = os.path.join(kdir, name), os.path.join(pdir, name)
        if name.endswith(".log"):
            same = compare_logs(kp, pp)
            rec[name] = "equal counters" if same else "differs"
            if not same:
                bad.append(f"{label} {name}: the logs differ")
            continue
        if name.endswith(".bins.pdf"):
            if open(kp).read() != open(pp).read():
                bad.append(f"{label} {name}: the bins differ")
            continue
        _, got = out_arrays(kp)
        _, ref = out_arrays(pp)
        if name.endswith(".pdf"):
            g, r = got["pdf"], ref["pdf"]
            moved = float(np.abs(g - r).sum()) / max(float(r.sum()), 1e-300)
            rec[name] = moved
            if not moved <= PDF_PATH_TOL:
                bad.append(f"{label} {name}: {moved:g} of the weight "
                           f"moved > {PDF_PATH_TOL}")
            continue
        var = file_variable(name)
        if var == "mhd_divb":
            continue
        _, ref0 = out_arrays(os.path.join(
            pdir, firsts[re.sub(r"\.\d{5}\.", ".", name)]))
        ref.pop("weights", None)
        scale = file_scale(ref, ref0)
        tol = SMR_PATH_TOL if var in OUT_STATE_VARS else DERIVED_PATH_TOL
        worst = (1.0, 0.0)
        for k in ref:
            t = tiers(got[k], ref[k], scale)
            worst = (min(worst[0], t[0]), max(worst[1], t[1]))
        rec[name] = worst
        if not (worst[0] > 0.95 and worst[1] < tol[1]):
            bad.append(f"{label} {name}: paths apart {worst} of "
                       f"{scale:g}")
    return rec, bad


def trilinear(data, geom, pt):
    """The host trilinear interpolation of a block's interior cells
    ``data`` [n3, n2, n1] (extents ``geom``) at ``pt`` (x, y, z)."""
    import numpy as np
    n3, n2, n1 = data.shape
    fr, idx = [], []
    for d, n in zip(range(3), (n1, n2, n3)):
        lo, hi = geom[2 * d], geom[2 * d + 1]
        dx = (hi - lo) / n
        f = (pt[d] - (lo + 0.5 * dx)) / dx
        i = int(np.clip(np.floor(f), 0, n - 2))
        idx.append(i)
        fr.append(f - i)
    (i, j, k), (a, b, c) = idx, fr
    cube = data[k:k + 2, j:j + 2, i:i + 2]
    w = np.array([[[(1 - c) * (1 - b) * (1 - a), (1 - c) * (1 - b) * a],
                   [(1 - c) * b * (1 - a), (1 - c) * b * a]],
                  [[c * (1 - b) * (1 - a), c * (1 - b) * a],
                   [c * b * (1 - a), c * b * a]]])
    return float((cube * w).sum())


def out_invariants(torch, label, rundir, mesh, phys, driver, state):
    """The invariants the files of a run must hold (each deck those of
    its outputs); returns (record, failures)."""
    import numpy as np
    from athenak_tpu_torch.vis.readers import read_binary
    rec, bad = {}, []
    names = out_listing(rundir)
    sz = mesh.mb_size
    vol = np.asarray(sz["dx1"]) * np.asarray(sz["dx2"]) \
        * np.asarray(sz["dx3"])
    ms = mesh.mesh_size
    domain = (ms.x1max - ms.x1min) * (ms.x2max - ms.x2min) \
        * (ms.x3max - ms.x3min)
    wbcc = [n for n in names if re.search(r"^\w+\.mhd_w_bcc\.\d+\.bin$", n)]
    final = read_binary(os.path.join(rundir, wbcc[-1])) if wbcc else None
    pdfs = {os.path.relpath(o.dname, "."): o for o in driver_outputs(driver)
            if o.params.file_type == "pdf"}
    for name in names:
        path = os.path.join(rundir, name)
        if name.endswith(".pdf") and not name.endswith(".bins.pdf"):
            o = pdfs[os.path.dirname(name)]
            dumps = [n for n in names if n.startswith(os.path.dirname(name))
                     and not n.endswith(".bins.pdf")]
            if not o.mass_weighted:
                want = domain
            elif name == dumps[-1] and final is not None:
                # the last dump and the final bin are of the final state
                want = float((final["mb_data"]["dens"].sum(axis=(1, 2, 3))
                              * vol).sum())
            else:
                continue
            tot = float(read_pdf(path).sum())
            err = abs(tot - want) / want
            rec["pdf_sum_err"] = max(rec.get("pdf_sum_err", 0.0), err)
            if not err <= OUT_SUM_TOL:
                bad.append(f"{label} {name}: weights sum {tot!r}, want "
                           f"{want!r}")
        elif name.startswith("sph" + os.sep):
            _, radii, wts, _ = read_sph(path)
            err = float(np.abs(wts.sum(axis=0) / (4 * np.pi * radii ** 2)
                               - 1).max())
            rec["sph_weight_err"] = max(rec.get("sph_weight_err", 0.0), err)
            if not err <= OUT_F32_TOL:
                bad.append(f"{label} {name}: weights sum {wts.sum(axis=0)}"
                           f" at r {radii}, not 4 pi r^2")
    if final is not None:
        cb = [n for n in names if n.endswith(".cbin")]
        if cb:
            c = read_binary(os.path.join(rundir, cb[-1]))
            err = 0.0
            for v, data in final["mb_data"].items():
                mom = c["mb_data"].get(v + "_1st", c["mb_data"].get(v))
                a = mom.mean(axis=(1, 2, 3))
                b = data.mean(axis=(1, 2, 3))
                err = max(err, float(np.abs(a - b).max())
                          / max(float(np.abs(data).max()), 1e-30))
            rec["cbin_mean_err"] = err
            if c["cycle"] != final["cycle"] or not err <= OUT_F32_TOL:
                bad.append(f"{label} cbin: block means {err:g} from the "
                           f"bin's (cycles {c['cycle']}, {final['cycle']})")
        carts = [n for n in names if n.startswith("cart" + os.sep)]
        if carts and mesh.nmb_total == 1:
            cyc, labels, arr = read_cart(os.path.join(rundir, carts[-1]))
            out = [o for o in driver_outputs(driver)
                   if o.params.file_type == "cartgrid"][0]
            xs, ys, zs = out.axis(0), out.axis(1), out.axis(2)
            geom = final["mb_geometry"][0]
            err = 0.0
            for s in range(8):
                i, j, k = (s * 5 + 1) % len(xs), (s * 3 + 2) % len(ys), \
                    (s * 7 + 3) % len(zs)
                for n, lab in enumerate(labels):
                    want = trilinear(final["mb_data"][lab][0], geom,
                                     (xs[i], ys[j], zs[k]))
                    scale = max(float(np.abs(final["mb_data"][lab]).max()),
                                1e-30)
                    err = max(err, abs(float(arr[n, k, j, i]) - want)
                              / scale)
            rec["cart_interp_err"] = err
            if cyc != final["cycle"] or not err <= OUT_F32_TOL:
                bad.append(f"{label} cartgrid: {err:g} from the host "
                           "interpolation of the bin dump")
    pd = [n for n in names if ".prtcl_d." in n]
    if pd:
        f = read_binary(os.path.join(rundir, pd[-1]))
        tot = float((f["mb_data"]["prtcl_d"].sum(axis=(1, 2, 3))
                     * vol).sum())
        nprt = int(state["prtcl_x"].shape[0])
        err = abs(tot - nprt) / nprt
        rec["prtcl_d_count_err"] = err
        if not err <= OUT_SUM_TOL:
            bad.append(f"{label} prtcl_d: sum times the volume {tot!r}, "
                       f"{nprt} particles")
    dv = [n for n in names if ".mhd_divb." in n]
    if dv:
        f = read_binary(os.path.join(rundir, dv[-1]))
        bmax = max(max(float(v.abs().max()) for v in state["bfc"].values()),
                   1e-30)
        lev = np.asarray(mesh.mb_lev)
        per = np.abs(f["mb_data"]["divb"]).max(axis=(1, 2, 3)) \
            * np.asarray(sz["dx1"])
        got = [float(per[lev == n].max()) / bmax for n in sorted(set(lev))]
        want = check_levels(torch, mesh, state, f"phase 25 {label}")
        rec["divb_by_level"] = got
        if max(got) > 1e-5 or any(abs(a - b) > 1e-5 * max(a, b, 1e-30)
                                  for a, b in zip(got, want)):
            bad.append(f"{label} mhd_divb by level {got}, the script's "
                       f"{want}")
    logs = [n for n in names if n.endswith(".log")]
    if logs:
        lines = open(os.path.join(rundir, logs[-1])).read().splitlines()
        cols = lines[0].lstrip("#").split()[2:]
        last = lines[-1].split()
        want = {k: int(v) for k, v in driver.ecounters.items()}
        got = dict(zip(cols, (int(v) for v in last[2:])))
        rec["log_last_row"] = got
        if got != want or int(last[1]) != mesh.ncycle:
            bad.append(f"{label} log: last row {last}, counters {want}")
    return rec, bad


def driver_outputs(driver):
    """The outputs of the run the driver made (``make_outputs`` on its
    parameters)."""
    from athenak_tpu_torch.outputs import make_outputs
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            return make_outputs(driver.pin, driver.mesh, driver.phys)
        finally:
            os.chdir(cwd)


def outputs_decks(torch, kernels, card):
    """Phase 25's runs (a lane): each deck of ``out_decks`` with its new
    outputs on the kernel path and the plain path, and on the kernel path
    without them; the files of the paths against each other, the
    invariants, and the launches exact: each kernel as often as without
    the new outputs, plus what the extra unpacks cost (the fills of one
    unpack, ``unpack_launches``, times the unpacks more)."""
    out, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        decks = out_decks(tmp)
        for label, (deck, extra, ncyc, blocks) in decks.items():
            rec = {}
            base = out_cli(torch, kernels, deck, extra, ncyc,
                           os.path.join(tmp, f"{label}_base"))
            per = unpack_launches(torch, kernels, deck, extra)
            runs = {}
            for use in ("true", "false"):
                rundir = os.path.join(tmp, f"{label}_{use}")
                runs[use] = out_cli(torch, kernels, deck,
                                    [*extra, *blocks,
                                     f"mhd/use_kernels={use}"],
                                    ncyc, rundir)
            got, clock, sec = (runs["true"][i] for i in (0, 5, 6))
            extra_unpacks = clock.calls.get("unpack", 0) \
                - base[5].calls.get("unpack", 0)
            want = {k: base[0][k] + extra_unpacks * per[k] for k in got}
            if got != want:
                bad.append(f"{label}: launches {got}, want {want} (without "
                           f"the outputs {base[0]}, {extra_unpacks} "
                           f"unpacks more of {per})")
            if any(runs["false"][0].values()):
                bad.append(f"{label}: the plain path launched "
                           f"{runs['false'][0]}")
            rec["launches"] = {k: v for k, v in got.items() if v}
            rec["launches_without_outputs"] = {k: v for k, v in
                                               base[0].items() if v}
            rec["unpack_launches"] = {k: v for k, v in per.items() if v}
            rec["extra_unpacks"] = extra_unpacks
            rec["paths"], b = compare_paths(
                label, os.path.join(tmp, f"{label}_true"),
                os.path.join(tmp, f"{label}_false"))
            bad += b
            for use in ("true", "false"):
                _, m, p, d, s, _, _ = runs[use]
                inv, b = out_invariants(torch, f"{label} {use}",
                                        os.path.join(tmp, f"{label}_{use}"),
                                        m, p, d, s)
                rec[f"invariants {use}"] = inv
                bad += b
            rec["write_seconds"] = clock.seconds
            rec["writes"] = clock.calls
            rec["run_seconds"] = sec
            rec["base_run_seconds"] = base[6]
            rec["output_share"] = (sum(clock.seconds.values())
                                   / max(sec, 1e-30))
            out[label] = rec
            print(f"phase 25: [{card}] {label} ({ncyc} cycles): launches "
                  f"{rec['launches']} (without the new outputs "
                  f"{rec['launches_without_outputs']}, {extra_unpacks} "
                  f"unpacks more of {rec['unpack_launches']}); paths "
                  f"{rec['paths']}; invariants {rec['invariants true']}; "
                  f"host s in writes {clock.seconds}, "
                  f"{rec['output_share']:.3f} of the {sec:.2f} s run",
                  flush=True)
            for use in ("base", "true", "false"):
                shutil.rmtree(os.path.join(tmp, f"{label}_{use}"))
    if bad:
        raise AssertionError("phase 25: " + "; ".join(bad))
    return out


def outputs_rank(ranks, deck, extra, ncyc, rundir, profdir):
    """A rank of phase 25's split pool: ``main.run`` with the outputs in
    ``rundir``, traced into ``profdir``."""
    import torch
    from athenak_tpu_torch import kernels
    from athenak_tpu_torch.main import run
    os.makedirs(rundir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(rundir)
    kernels.reset_counts()
    try:
        mesh, _, _, _ = run(pin_for(list(extra) + [f"time/nlim={ncyc}"],
                                    deck), ranks=ranks, profile_dir=profdir)
    finally:
        os.chdir(cwd)
    _sync(torch)
    return {"ncycle": mesh.ncycle,
            "launches": {k.name: k.launches for k in kernels.ALL
                         if k.launches}}


def outputs_split(torch, kernels, card):
    """The pool deck split over 2 gloo ranks on this card with ``cbin``,
    a joint ``pdf`` and a ``bin`` of ``mhd_jcon`` (the 4-current reads the
    whole mesh's prior state, collected on rank 0), each rank traced
    (``-p``'s ``profile_dir``): rank 0's files byte-equal to the one-rank
    run's, one trace a rank, named by rank."""
    from athenak_tpu_torch.main import run
    from athenak_tpu_torch.parallel import spawn_ranks
    dev = os.environ.get("ATHENAK_DEVICE", "cuda")
    if dev == "cuda":
        kernels.library()   # built here, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        deck = os.path.join(tmp, "pool.athinput")
        with open(deck, "w") as f:
            f.write(POOL_DECK)
        ncyc = NCYC_OUT_DECK
        one = os.path.join(tmp, "one")
        os.makedirs(one)
        cwd = os.getcwd()
        os.chdir(one)
        try:
            run(pin_for(OUT_SPLIT + [f"time/nlim={ncyc}"], deck),
                device=dev)
        finally:
            os.chdir(cwd)
        split, prof = os.path.join(tmp, "split"), os.path.join(tmp, "prof")
        t = time.perf_counter()
        recs = spawn_ranks("chip_smoke:outputs_rank", 2, backend="gloo",
                           device=dev, args=(deck, OUT_SPLIT, ncyc,
                                                split, prof),
                           timeout=SHARD_TIMEOUT)
        spawn_s = time.perf_counter() - t
        names = out_listing(one)
        if names != out_listing(split):
            raise AssertionError(f"phase 25 split pool: files {names} and "
                                 f"{out_listing(split)}")
        differ = [n for n in names
                  if open(os.path.join(one, n), "rb").read()
                  != open(os.path.join(split, n), "rb").read()]
        if differ:
            raise AssertionError(f"phase 25 split pool: rank 0's {differ} "
                                 "differ from one rank's")
        traces = sorted(os.listdir(prof))
        if [t.split(".")[0] for t in traces] != ["rank0", "rank1"]:
            raise AssertionError(f"phase 25 split pool: traces {traces}")
        sizes = {t: os.path.getsize(os.path.join(prof, t)) for t in traces}
    out = {"files": names, "byte_equal": True, "traces": sizes,
           "launches_by_rank": [r["launches"] for r in recs],
           "spawn_seconds": spawn_s}
    print(f"phase 25: [{card}] pool on 2 gloo ranks: {len(names)} files "
          f"byte-equal to one rank's ({names}); traces {sizes}; launches "
          f"a rank {out['launches_by_rank']}", flush=True)
    return out


def outputs_profile(torch, kernels, card):
    """``-p``, in a fresh process: the blast through ``main.cli -p DIR``
    for OUT_PROFILE_CYCLES cycles; the trace parses as JSON and names
    kernel A's and B's CUDA functions as often as their wrappers counted
    (A twice a cycle)."""
    from athenak_tpu_torch import main as cli_main
    n = OUT_PROFILE_CYCLES
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_counts()
        try:
            cli_main.cli(["-i", DECK, "-d", tmp, "-p", "prof",
                          f"time/nlim={n}"])
        finally:
            os.chdir(cwd)
        _sync(torch)
        traces = [f for f in os.listdir(os.path.join(tmp, "prof"))
                  if f.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"phase 25 -p: traces {traces}")
        path = os.path.join(tmp, "prof", traces[0])
        size = os.path.getsize(path)
        with open(path) as f:
            trace = json.load(f)
    kern = [e.get("name", "") for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel"]
    a = sum("stage_kernel" in k for k in kern)
    b = sum("periodic_fill_kernel" in k for k in kern)
    want_b = kernels.PERIODIC_FILL_CC.launches \
        + kernels.PERIODIC_FILL_FC.launches
    rec = {"trace_bytes": size, "kernel_events": len(kern),
           "stage_kernel": a, "periodic_fill_kernel": b,
           "launches": {k.name: k.launches for k in kernels.ALL
                        if k.launches}}
    print(f"phase 25: [{card}] -p on the blast, {n} cycles: a "
          f"{size}-byte trace, {len(kern)} kernel events, kernel A's "
          f"stage_kernel {a} (counted {kernels.MEGA_STAGE_V2.launches}), "
          f"kernel B's periodic_fill_kernel {b} (counted {want_b})",
          flush=True)
    if not (a == 2 * n == kernels.MEGA_STAGE_V2.launches and b == want_b
            and b > 0):
        raise AssertionError(f"phase 25 -p: the trace names A {a} times "
                             f"and B {b} times, want {2 * n} and {want_b}")
    return rec


def phase_outputs(torch, kernels, card):
    """Phase 25's timings (main process): the host ms of one write of
    each of the blast's outputs at 124^3 (kernel path, after one cycle),
    the card synchronised around it, and of the unpack they read."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.outputs import make_outputs
    pin = pin_for(OUT_BLAST)
    mesh, phys, _, driver, state = build(pin)
    state = driver.initialize(state)
    state, _, counters = driver.make_cycle_fn()(state, mesh.dt)
    mesh.ncycle, mesh.time = 1, mesh.dt
    driver.ecounters = {k: int(v) for k, v in counters.items()}
    out = {"unpack": host_ms(torch, lambda: phys.unpack_state(state))}
    view = phys.unpack_state(state)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for o in make_outputs(pin, mesh, phys, driver):
                p = o.params
                key = "log" if p.file_type == "log" else \
                    f"{p.file_type} {p.variable}"
                if getattr(o, "var2", None):
                    key += f" x {o.var2}"
                out[key] = host_ms(torch, lambda: o.write(mesh, view),
                                   reps=1)
                for d, _, files in os.walk(tmp):
                    for f in files:
                        os.remove(os.path.join(d, f))
        finally:
            os.chdir(cwd)
    print(f"phase 25: [{card}] host ms of one write on the 124^3 blast "
          f"(the card synchronised): "
          + ", ".join(f"{k} {v:.2f}" for k, v in out.items()), flush=True)
    return out


# ---------------------------------------------------------------- phase 26
# the batched cycle window: two batches of 16 cycles on the six decks;
# the timed batch after a warm-up batch
NCYC_WIN = 32
NCYC_WIN_TIME = 16
WIN_DECKS = {
    "blast": (DECK, []),
    "pool": (POOL_DECK, []),
    "z4c": (Z4C_DECK, []),
    "puncture": (PUNCTURE, ["job/precision=single"]),
    "smr": (SMR_DECK, SMR_FULL + ["job/precision=single"]),
    "sr_blast": (SR_DECK, []),
}
# the decks whose window must replay from a CUDA graph (the SR blast's
# Illinois c2p keeps its window eager) and the kernels each must launch
WIN_GRAPHED = ("blast", "pool", "z4c", "puncture", "smr")
WIN_KERNELS = {"blast": ("mega_stage_v2", "periodic_fill_cc",
                         "periodic_fill_fc"),
               "pool": ("mega_stage_v2", "pool_fill"),
               "z4c": ("z4c_stage", "z4c_outflow_fill"),
               "puncture": ("z4c_stage", "z4c_outflow_fill"),
               "smr": ("fused_flux_dir",),
               "sr_blast": ("fused_stage3d", "fused_ct3d")}
# the window's float32 time and dt against the host's float64 chain
# after NCYC_WIN cycles (ROADMAP F32): each step rounds once in float32
WIN_TIME_RTOL = 1e-5


def strip_outputs(text: str) -> str:
    """A deck's text without its ``<outputN>`` blocks."""
    out, skip = [], False
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("<") and s.endswith(">"):
            skip = s.startswith("<output")
        if not skip:
            out.append(line)
    return "\n".join(out) + "\n"


def window_pin(label, extra=()):
    """A deck of WIN_DECKS without its outputs (the window's condition),
    with its overrides and ``extra``."""
    from athenak_tpu_torch.athinput import ParameterInput
    src, base = WIN_DECKS[label]
    if "\n" not in src:
        with open(src) as f:
            src = f.read()
    pin = ParameterInput.from_string(strip_outputs(src))
    pin.modify_from_cmdline(list(base) + list(extra))
    return pin


def window_run(torch, kernels, label, ncyc, path, prec=None, extra=()):
    """``label`` for ncyc cycles through build, initialize and execute on
    one of three paths: "graph" (the window as the predicate sends it),
    "eager" (the window with ``Driver.window_graphs`` off) or "loop"
    (the per-cycle loop, reached as the JAX package's tests reach it:
    ``verbose``), the launch counts set to 0 just before execute;
    ``extra`` overrides the deck."""
    import contextlib
    import io
    from athenak_tpu_torch.main import build
    extra = [f"time/nlim={ncyc}", *extra] + (
        [f"job/precision={prec}"] if prec else [])
    mesh, phys, _, driver, state = build(window_pin(label, extra),
                                         device="cuda")
    state = driver.initialize(state)
    init = {k: v.clone() for k, v in state.items() if hasattr(v, "clone")}
    init.update({k: {c: t.clone() for c, t in v.items()}
                 for k, v in state.items() if isinstance(v, dict)})
    driver.window_graphs = path == "graph"
    kernels.reset_counts()
    if path == "loop":
        with contextlib.redirect_stdout(io.StringIO()):
            state = driver.execute(state, verbose=True)
    else:
        state = driver.execute(state)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.ALL}
    per = None
    if driver._window_graph is not None:
        per = dict(zip([k.name for k in kernels.ALL],
                       driver._window_graph[1].launched))
    return {"state": state, "init": init, "mesh": mesh, "phys": phys,
            "driver": driver,
            "launches": launches, "window": driver.window,
            "per_capture": per, "time": mesh.time, "dt": mesh.dt,
            "ncycle": mesh.ncycle, "counters": dict(driver.ecounters)}


def window_same(a, b, label):
    """Two runs bitwise equal: every leaf's bytes, time, dt, cycles,
    counters and launches."""
    da, db = leaf_digests(a["state"]), leaf_digests(b["state"])
    diff = [k for k in da if da[k] != db.get(k)]
    if diff or set(da) != set(db):
        raise AssertionError(f"{label}: leaves {diff} differ")
    for key in ("time", "dt", "ncycle", "counters", "launches"):
        if a[key] != b[key]:
            raise AssertionError(f"{label}: {key} {a[key]} != {b[key]}")


def window_tiers(torch, a, b, label):
    """The window's float32 run against the per-cycle loop's, with the
    repo's path tiers: every cell and face array of an MHD state with
    more than 95% of its interior within SMR_PATH_TOL[0] and all of it
    within SMR_PATH_TOL[1] of the largest change the loop's run made to
    any of its arrays (phase 25's scale: the blast barely changes its
    field, where a rounding-level difference flips GS07 upwind selects,
    ROADMAP F4), a Z4c state within Z4C_PATH_TOL (``z4c_paths_apart``);
    time and dt within WIN_TIME_RTOL; cycles, counters and launches
    equal.  Returns each leaf's (share, max)."""
    out = {}

    def leaves(st, prefix=""):
        for k, v in st.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            elif hasattr(v, "is_floating_point") and v.is_floating_point() \
                    and v.dim() >= 4:
                yield prefix + k, v

    ref = dict(leaves(b["state"]))
    init = dict(leaves(b["init"]))
    z4c = a["phys"].__class__.__name__ == "Z4c"
    ng = a["mesh"].mb_indcs.ng
    keys = [k for k, _ in leaves(a["state"]) if k in init]
    scale = max(float((interior(ref[k], ng).double()
                       - interior(init[k], ng).double()).abs().max())
                for k in keys)
    for k, v in leaves(a["state"]):
        if z4c:
            err = z4c_paths_apart(interior(v, ng), interior(ref[k], ng))
            ok = err <= Z4C_PATH_TOL
            out[k] = err
        else:
            rel = ((interior(v, ng).double() - interior(ref[k], ng).double())
                   .abs() / max(scale, 1e-30))
            out[k] = (float((rel < SMR_PATH_TOL[0]).double().mean()),
                      float(rel.max()))
            ok = out[k][0] > 0.95 and out[k][1] < SMR_PATH_TOL[1]
        if not ok:
            raise AssertionError(f"{label} {k}: {out[k]}")
    for key in ("time", "dt"):
        if not math.isclose(a[key], b[key], rel_tol=WIN_TIME_RTOL):
            raise AssertionError(f"{label}: {key} {a[key]!r} against "
                                 f"{b[key]!r}")
    for key in ("ncycle", "counters", "launches"):
        if a[key] != b[key]:
            raise AssertionError(f"{label}: {key} {a[key]} != {b[key]}")
    out["scale"] = scale
    out["time_rel"] = abs(a["time"] - b["time"]) / abs(b["time"])
    out["dt_rel"] = abs(a["dt"] - b["dt"]) / abs(b["dt"])
    return out


def window_deck_checks(torch, kernels, label):
    """Phase 26's runs of one deck (see ``window_checks``)."""
    rec = {}
    eager = window_run(torch, kernels, label, NCYC_WIN, "eager")
    loop = window_run(torch, kernels, label, NCYC_WIN, "loop")
    graph = window_run(torch, kernels, label, NCYC_WIN, "graph")
    w = graph["window"]
    rec["window"] = w
    if label in WIN_GRAPHED:
        if not (w["graph"] and w["captures"] == 1
                and w["replays"] == w["batches"] == NCYC_WIN // 16):
            raise AssertionError(f"phase 26 {label}: window {w}")
        per = graph["per_capture"]
        got = {k: w["launches"].get(k, 0) for k in per}
        if got != {k: w["replays"] * n for k, n in per.items()} \
                or w["launches"] != eager["window"]["launches"]:
            raise AssertionError(f"phase 26 {label}: the window's launches "
                                 f"{w['launches']}, {w['replays']} replays "
                                 f"of {per}, the eager window's "
                                 f"{eager['window']['launches']}")
        rec["per_capture"] = {k: v for k, v in per.items() if v}
    elif w["graph"] or w["captures"]:
        raise AssertionError(f"phase 26 {label}: the window should stay "
                             f"eager, got {w}")
    for name in WIN_KERNELS[label]:
        if not graph["launches"][name] > 0:
            raise AssertionError(f"phase 26 {label}: {name} not launched")
    window_same(graph, eager, f"phase 26 {label} graph vs eager")
    rec["launches"] = {k: v for k, v in graph["launches"].items() if v}
    rec["vs_loop_f32"] = window_tiers(torch, eager, loop,
                                      f"phase 26 {label} window vs loop")
    del eager, loop, graph
    torch.cuda.empty_cache()
    w64 = window_run(torch, kernels, label, NCYC_WIN, "graph", "double")
    l64 = window_run(torch, kernels, label, NCYC_WIN, "loop", "double")
    window_same(w64, l64, f"phase 26 {label} f64 window vs loop")
    rec["f64_window"] = w64["window"]
    rec["f64_launches"] = {k: v for k, v in w64["launches"].items() if v}
    return rec


def step_checks(torch, kernels, card):
    """Kernels A, C, D, E and H given the step as a 0-d tensor on the
    card: against their plain versions on the same tensor at the
    existing tiers (A, C, D two-tier, dtmin rtol 1e-4, counts equal; E
    1e-6 of the field scale; H 2e-5 of max(|value|, 1)), and each
    captured in a CUDA graph, replayed after the step tensor was
    overwritten, bitwise its eager launch on the new step (the cells
    the kernels write)."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import stage, stage_split, stage_v1
    from athenak_tpu_torch.ops import z4c_stage as zs

    def flat(x):
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in flat(x[k])]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in flat(v)]
        return [x] if hasattr(x, "data_ptr") else []

    def captured(label, fn, step):
        fn(step)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fn(step)
        step.mul_(0.75)
        g.replay()
        ref = fn(step)
        torch.cuda.synchronize()
        for a, b in zip(flat(out), flat(ref)):
            # the kernels leave their outputs' ghost cells unwritten:
            # compare three cells in from every face (ng 2 and 3)
            if a.dim() >= 3:
                a, b = interior(a, 3), interior(b, 3)
            if not torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                               b.reshape(-1).contiguous().view(torch.uint8)):
                raise AssertionError(f"phase 26 {label}: the replay on a "
                                     "new step differs from its eager "
                                     "launch")
        return True

    def deck(label):
        mesh, phys, _, driver, st = build(window_pin(label), device="cuda")
        # w and bcc too (kernel A's route drops them)
        st = phys.unpack_state(driver.initialize(st))
        return mesh, phys, st

    res = {}
    for label in ("blast", "pool"):
        mesh, phys, st = deck(label)
        step = torch.full((), 0.5 * mesh.dt, dtype=st["u"].dtype,
                          device="cuda")

        def run_a(s, plain=False):
            fn = stage.mega_stage_v2_plain if plain else stage.mega_stage_v2
            return fn(st["u"], st["bfc"], st["u"], st["bfc"], phys.eos, 0.5,
                      0.5, s, phys.dxs)

        # phase 3's measures: u per channel, the faces on the largest
        # interior face value
        got, want = run_a(step), run_a(step, plain=True)
        uscale = interior(want[0]).abs().amax(dim=(-3, -2, -1),
                                              keepdim=True)
        bscale = max(float(interior(v).abs().max()) for v in want[1].values())
        err = two_tier(interior(got[0]), interior(want[0]), uscale,
                       f"phase 26 A {label}")
        for c in ("x1f", "x2f", "x3f"):
            err = max(err, two_tier(interior(got[1][c]),
                                    interior(want[1][c]), bscale,
                                    f"phase 26 A {label} {c}"))
        for key in ("neos_dfloor", "neos_efloor", "neos_tfloor"):
            if int(got[2][key]) != int(want[2][key]):
                raise AssertionError(f"phase 26 A {label}: {key}")
        if not math.isclose(float(got[2]["dtmin"]), float(want[2]["dtmin"]),
                            rel_tol=1e-4):
            raise AssertionError(f"phase 26 A {label}: dtmin")
        res[f"A {label}"] = {"max_abs_err": err,
                             "graph": captured(f"A {label}", run_a, step)}
        if label == "blast":
            def run_e(s, plain=False):
                fn = stage_v1.fused_mega_stage3d_plain if plain else \
                    stage_v1.fused_mega_stage3d
                return fn(st["w"], st["bcc"], st["bfc"], st["u"], st["u"],
                          st["bfc"], phys.eos, 0.5, 0.5, s, phys.dxs)

            # phase 7's measure: within 1e-6 of the field's scale
            got, want = run_e(step), run_e(step, plain=True)
            err = check_pair(torch, interior(got[0]), interior(want[0]),
                             interior(want[0]).abs().amax(
                                 dim=(-3, -2, -1), keepdim=True),
                             "phase 26 E blast", True)
            for c in ("x1f", "x2f", "x3f"):
                err = max(err, check_pair(
                    torch, interior(got[1][c]), interior(want[1][c]),
                    max(float(interior(v).abs().max())
                        for v in want[1].values()),
                    f"phase 26 E blast {c}", True))
            res["E blast"] = {"max_abs_err": err,
                              "graph": captured("E blast", run_e, step)}
        del st
    mesh, phys, st = deck("sr_blast")
    step = torch.full((), 0.5 * mesh.dt, dtype=st["u"].dtype, device="cuda")
    solver = stage_split.solver_for(phys)

    def run_c(s, plain=False):
        fn = stage_split.fused_stage3d_plain if plain else \
            stage_split.fused_stage3d
        return fn(st["w"], st["bcc"], st["bfc"], st["u"], st["u"], phys.eos,
                  0.5, 0.5, s, phys.dxs, solver)

    # phase 5's measures: acc per channel, the mass fluxes and face EMFs
    # on their largest face value, the new faces on the largest field
    got, want = run_c(step), run_c(step, plain=True)
    err = two_tier(interior(got[0]), interior(want[0]),
                   interior(want[0]).abs().amax(dim=(-3, -2, -1),
                                                keepdim=True),
                   "phase 26 C sr_blast acc")
    for i, name in ((1, "fden"), (2, "emf")):
        sc = max(max(float(faces(v).abs().max())
                     for v in want[i].values()), 1e-30)
        for k in want[i]:
            err = max(err, two_tier(faces(got[i][k]), faces(want[i][k]), sc,
                                    f"phase 26 C sr_blast {name}[{k}]"))
    res["C sr_blast"] = {"max_abs_err": err,
                         "graph": captured("C sr_blast", run_c, step)}
    acc, fden, emf = want
    fden = {k: v.contiguous() for k, v in fden.items()}
    emf = {k: v.contiguous() for k, v in emf.items()}

    def run_d(s, plain=False):
        fn = stage_split.fused_ct3d_plain if plain else stage_split.fused_ct3d
        return fn(st["w"], st["bcc"], fden, emf, st["bfc"], st["bfc"], 0.5,
                  0.5, s, phys.dxs, is_sr=True)

    got, want = run_d(step), run_d(step, plain=True)
    bscale = max(float(interior(v).abs().max()) for v in want.values())
    err = max(two_tier(interior(got[c]), interior(want[c]), bscale,
                       f"phase 26 D sr_blast {c}") for c in want)
    res["D sr_blast"] = {"max_abs_err": err,
                         "graph": captured("D sr_blast", run_d, step)}
    del st, acc, fden, emf
    for label in ("z4c", "puncture"):
        mesh, phys, st = deck(label)
        u = st["u"]
        u1 = (u.double() * 1.001).to(u.dtype)
        step = torch.full((), 0.25 * mesh.dt, dtype=u.dtype, device="cuda")

        def run_h(s, plain=False):
            fn = zs.fused_z4c_stage_plain if plain else zs.fused_z4c_stage
            return fn(u, u1, phys, 0.5, 0.5, s)

        got, want = run_h(step), run_h(step, plain=True)
        a = interior(got, phys.ng).double()
        b = interior(want, phys.ng).double()
        rel = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
        if not rel <= 2e-5:
            raise AssertionError(f"phase 26 H {label}: {rel:g}")
        res[f"H {label}"] = {"max_rel_err": rel,
                             "graph": captured(f"H {label}", run_h, step)}
        del st, u, u1
    print(f"phase 26: [{card}] the step from device memory: {res}")
    return res


def window_checks(torch, kernels, card):
    """Phase 26's untimed checks (a lane): on every deck of WIN_DECKS,
    the graphed window bitwise the eager window over two batches (one
    capture, a replay a batch, every kernel's launches replays x the
    capture's), the eager window against the per-cycle loop (float32
    within the path tiers, float64 bitwise), and the stage kernels'
    step from device memory (``step_checks``)."""
    res = {label: window_deck_checks(torch, kernels, label)
           for label in WIN_DECKS}
    res["step"] = step_checks(torch, kernels, card)
    print(f"phase 26: [{card}] window checks {res}")
    return res


def window_rate(torch, kernels, label, path, extra=()):
    """zone-cycles/s of ``label`` on one path (see ``window_run``) over
    NCYC_WIN_TIME cycles after a warm-up (one cycle; on the graph path a
    batch, which captures the window the timed run replays), CUDA events;
    the captures and replays, the launches of both runs, the peak memory
    of the run, and on the graph path the ms of the copy of the state
    into the capture's buffers and out of them; ``extra`` overrides the
    deck."""
    import contextlib
    import io
    from athenak_tpu_torch.main import build
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warm_cycles = NCYC_WIN_TIME if path == "graph" else 1
    mesh, phys, _, driver, state = build(
        window_pin(label, [f"time/nlim={warm_cycles}", *extra]),
        device="cuda")
    # unpacked as execute returns it (kernel A's route drops w and bcc),
    # so the timed window reuses the warm-up's capture
    state = phys.unpack_state(driver.initialize(state))
    driver.window_graphs = path == "graph"
    kernels.reset_counts()

    def run(state):
        if path == "loop":
            with contextlib.redirect_stdout(io.StringIO()):
                return driver.execute(state, verbose=True)
        return driver.execute(state)

    state = run(state)
    warm = dict(driver.window or {})
    driver.nlim = mesh.ncycle + NCYC_WIN_TIME
    n0 = mesh.ncycle
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    state = run(state)
    e1.record()
    torch.cuda.synchronize()
    sec = e0.elapsed_time(e1) / 1e3
    mbi = mesh.mb_indcs
    cells = mesh.nmb_total * mbi.nx1 * mbi.nx2 * mbi.nx3
    rec = {"zcps": (mesh.ncycle - n0) * cells / sec, "cycles": mesh.ncycle,
           "warm_window": warm, "window": driver.window,
           "launches": {k.name: k.launches for k in kernels.ALL},
           "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    if path == "graph" and driver._window_graph is not None:
        g = driver._window_graph[1]
        scalars = [t.clone() for t in g.static[1]]
        ms_in, ms_out = [], []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            c = torch.cuda.Event(enable_timing=True)
            a.record()
            g.load(state, scalars)
            b.record()
            out = g.state()
            c.record()
            torch.cuda.synchronize()
            ms_in.append(a.elapsed_time(b))
            ms_out.append(b.elapsed_time(c))
            del out
        rec["copy_in_ms"], rec["copy_out_ms"] = min(ms_in), min(ms_out)
        rec["state_mb"] = sum(t.numel() * t.element_size()
                              for t in g.static[0].values()
                              if hasattr(t, "numel")) / 2**20
    return rec


def phase_window(torch, kernels, card):
    """Phase 26's timings (the main process): every deck of WIN_DECKS on
    the per-cycle loop, the eager window and (where the predicate admits
    it) the graphed window."""
    res = {}
    for label in WIN_DECKS:
        paths = ("loop", "eager") + (("graph",) if label in WIN_GRAPHED
                                     else ())
        res[label] = {p: window_rate(torch, kernels, label, p)
                      for p in paths}
        torch.cuda.empty_cache()
        r = res[label]
        print(f"phase 26: [{card}] {label} zone-cycles/s "
              + ", ".join(f"{p} {r[p]['zcps']:.4g}" for p in paths)
              + f"; peak GB {[round(r[p]['peak_gb'], 3) for p in paths]}"
              + (f"; copy in/out ms {r['graph']['copy_in_ms']:.4f} / "
                 f"{r['graph']['copy_out_ms']:.4f} of "
                 f"{r['graph']['state_mb']:.1f} MB; window "
                 f"{r['graph']['window']}" if "graph" in r else
                 f"; window {r['eager']['window']}"))
    return res


# ---------------------------------------------------------------------------
# phase 27: the configurations the JAX package runs on its NamedSharding
# gather path, split over the ranks of a process group at the widths their
# decks are timed at on one card, each as several blocks
NCYC_GATHER = 10
# the AMR pool refines at cycle 18 at 128^3 (phase 17's blast_amr_128)
NCYC_GATHER_AMR = 20
# the multigrid at 128^3 in float64: two solves a cycle
NCYC_GATHER_MG = 4
NCYC_GATHER_TIMED = 3
BLOCKS64 = ["meshblock/nx1=64", "meshblock/nx2=64", "meshblock/nx3=64"]
# 0.0999 particles a cell of 124^3: 190,471, which neither 2 nor 3
# divides
PART_UNEVEN = ["meshblock/nx1=62", "meshblock/nx2=62", "meshblock/nx3=62",
               "particles/ppc=0.0999"]
# the decks whose stage kernels run on one rank (J; E and F): each rank
# launches them as often as one rank does
GATHER_STAGE = ("sbox_wide", "amr_wide", "part_blast")


def gather_jobs(tmp, world=2):
    """(label, deck, overrides, cycles, ranks) of phase 27: JEANS_BIG
    (the FFT) in 8 blocks of 128 x 64 x 64, selfgravity 128^3 in float64
    (the multigrid) in 8 of 64^3, SBOX_WIDE (the shearing box, J) in 8
    of 64^3, AMR_WIDE with its block pool (J), the shipped shadow (the
    user boundary) in 8 blocks of 16 x 64, each on ``world`` ranks, and
    PART_BLAST in 8 blocks of 62^3 with 190,471 particles on
    ``world + 1``."""
    part = os.path.join(tmp, "part_blast.athinput")
    with open(DECK) as f, open(part, "w") as g:
        g.write(f.read() + "\n" + particles_block())
    return [("jeans_big", JEANS, JEANS_BIG + [
                "meshblock/nx1=128", "meshblock/nx2=64",
                "meshblock/nx3=64"], NCYC_GATHER, world),
            ("selfgrav_128", SELFGRAV, SELFGRAV_BIG + BLOCKS64,
             NCYC_GATHER_MG, world),
            ("sbox_wide", SBOX_UNSTRAT, SINGLE + SBOX_WIDE + BLOCKS64,
             NCYC_GATHER, world),
            ("amr_wide", BLAST_AMR, AMR_WIDE, NCYC_GATHER_AMR, world),
            ("shadow", RAD_SHIPPED["shadow"], ["meshblock/nx1=16",
                                               "meshblock/nx2=64"],
             NCYC_GATHER, world),
            ("part_blast", part, PART_UNEVEN, NCYC_GATHER, world + 1)]


def split_gather(torch, kernels, card):
    """Phase 27's checks (a lane): every job of ``gather_jobs`` on its
    gloo ranks on this card against its one-rank run here, bitwise, the
    solves and V-cycles of every rank one rank's, the launches a rank
    as derived (``shard_compare``)."""
    from athenak_tpu_torch.parallel import spawn_ranks
    kernels.library()   # built here, before the ranks load it
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = gather_jobs(tmp)
        refs = {}
        for label, deck, extra, ncyc, _ in jobs:
            refs[label] = shard_job(torch, kernels, None, deck, extra, ncyc)
            torch.cuda.empty_cache()
        t = time.perf_counter()
        got = spawn_ranks("chip_smoke:shard_rank", max(j[4] for j in jobs),
                          backend="gloo", device="cuda", args=(jobs,),
                          timeout=SHARD_TIMEOUT)[0]
        out["spawn_seconds"] = time.perf_counter() - t
    for label, deck, extra, ncyc, world in jobs:
        rec = shard_compare(label, refs[label], got[f"{label} {world}"],
                            ncyc, world, card, stage=label in GATHER_STAGE,
                            phase="27")
        if label == "selfgrav_128" and not rec["solves"][1] > 0:
            raise AssertionError("phase 27 selfgrav_128: no V-cycle ran")
        out[f"{label} on {world} ranks"] = rec
    return out


def phase_split_gather(torch, kernels, card):
    """Phase 27's timings (main process): each deck of ``gather_jobs`` on
    one rank and on 2 gloo ranks on this card (zone-cycles/s of
    NCYC_GATHER_TIMED cycles after a warm-up cycle, the slowest rank's;
    the bytes a rank sends a cycle, point to point and into
    all-gathers).  With two cards or more, also on one rank a card under
    nccl (at most 4), each deck's run there bitwise its one-rank run."""
    from athenak_tpu_torch.parallel import spawn_ranks
    kernels.library()   # built here, before the ranks load it
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(lb, d, e, NCYC_GATHER_TIMED, 2)
                for lb, d, e, _, _ in gather_jobs(tmp)]
        for label, deck, extra, ncyc, _ in jobs:
            out[f"{label} 1"] = {"zcps": shard_timed(
                torch, None, deck, extra, ncyc)["zcps"]}
            torch.cuda.empty_cache()
        got = spawn_ranks("chip_smoke:shard_rank", 2, backend="gloo",
                          device="cuda", args=(jobs, True),
                          timeout=SHARD_TIMEOUT)[0]
        runs = {f"{k} gloo": v for k, v in got.items()}
        ncard = torch.cuda.device_count()
        if ncard >= 2:
            nw = min(ncard, 4)
            njobs = [(lb, d, e, n, nw)
                     for lb, d, e, n, _ in gather_jobs(tmp)]
            runs.update({f"{k} nccl": v for k, v in spawn_ranks(
                "chip_smoke:shard_rank", nw, backend="nccl",
                args=([(lb, d, e, NCYC_GATHER_TIMED, w)
                       for lb, d, e, _, w in njobs], True),
                timeout=SHARD_TIMEOUT)[0].items()})
            recs = spawn_ranks("chip_smoke:shard_rank", nw, backend="nccl",
                               args=(njobs,), timeout=SHARD_TIMEOUT)[0]
            checks = {}
            for label, deck, extra, ncyc, world in njobs:
                ref = shard_job(torch, kernels, None, deck, extra, ncyc)
                checks[f"{label} on {world} ranks"] = shard_compare(
                    label, ref, recs[f"{label} {world}"], ncyc, world,
                    card, backend="nccl", stage=label in GATHER_STAGE,
                    phase="27")
                torch.cuda.empty_cache()
            out["nccl_checks"] = checks
    for name, rec in runs.items():
        slow = max(r["sec"] for r in rec["by_rank"])
        out[name] = {
            "zcps": rec["zcps"] * rec["sec"] / slow,
            "cycle_sent_bytes_a_rank": [int(r["cycle_sent_bytes"])
                                        for r in rec["by_rank"]],
            "cycle_gathered_bytes_a_rank": [
                int(r["cycle_gathered_bytes"]) for r in rec["by_rank"]],
            "fill_ms_a_rank": [r["fill_ms"] for r in rec["by_rank"]],
            "density_gather_ms_a_rank": [r["gather_ms"]
                                         for r in rec["by_rank"]]}
    for name, rec in out.items():
        if name == "nccl_checks":
            continue
        extra = "" if "fill_ms_a_rank" not in rec else (
            f", bytes a rank sends a cycle: exchange "
            f"{rec['cycle_sent_bytes_a_rank']}, all-gathers "
            f"{rec['cycle_gathered_bytes_a_rank']}; ms of a fill of u "
            f"{[round(x, 3) for x in rec['fill_ms_a_rank']]}, of an "
            f"all-gather of the density "
            f"{[round(x, 3) for x in rec['density_gather_ms_a_rank']]}")
        print(f"phase 27: [{card}] {name} rank(s): {rec['zcps']:.4g} "
              f"zone-cycles/s{extra}")
    return out


# ---------------------------------------------------------------------------
# phase 28: MHD under RK4 (ROADMAP F33): the 124^3 blast on kernel A and
# the SR blast on kernels C + D, four stages a cycle
# ---------------------------------------------------------------------------
RK4 = ["time/integrator=rk4"]
NCYC_RK4 = 10
NCYC_RK4_SR = 5
# the fills of the blast outside its stages (phase 4's RK2 run: 2 n + 4):
# the initial fill and the unpacks of its bin output
BLAST_FILLS = 4


def rk4_paths(torch, kernels, label, deck, ncyc, expect):
    """``deck`` under RK4 through the CLI for ncyc cycles on both paths
    (``mhd/use_kernels``), the counts set to 0 just before each run: the
    kernel path's launches exactly ``expect(n)`` and the plain path's
    none, each state finite with div B and the mass kept
    (``check_state``), u and every face array within SMR_PATH_TOL's tiers
    of the largest change the plain path made to any of them (the scale
    phases 25 and 26 hold the blast's paths to: the blast barely changes
    its field, where a rounding-level difference flips GS07 upwind
    selects, ROADMAP F4); each array's share and max on its own change
    (``change_diff``) recorded beside."""
    from athenak_tpu_torch.main import build
    _, _, _, _, st0 = build(pin_for(RK4, deck), device="cuda")
    init = {"u": st0["u"], **st0["bfc"]}
    del st0
    states, rec = {}, {}
    for use in ("true", "false"):
        got, mesh, phys, driver, state, dmass, _ = run_cli(
            torch, kernels, deck, ncyc, RK4 + [f"mhd/use_kernels={use}"])
        got = {k: v for k, v in got.items() if v}
        want = expect(mesh.ncycle) if use == "true" else {}
        if got != want or driver.integrator.name != "rk4":
            raise AssertionError(f"phase 28 {label} use_kernels={use}: "
                                 f"launches {got}, expected {want} "
                                 f"({driver.integrator.name})")
        divb = check_state(torch, phys, state, dmass,
                           f"phase 28 {label} {use}")
        states[use] = state
        rec[use] = {"launches": got, "div_b": divb, "mass_drift": dmass,
                    "counters": dict(driver.ecounters),
                    "window": driver.window}
    k, p = states["true"], states["false"]
    pairs = [("u", k["u"], p["u"])] + [(c, k["bfc"][c], p["bfc"][c])
                                       for c in k["bfc"]]
    scale = max(float((interior(b) - interior(init[key])).abs().max())
                for key, _, b in pairs)
    diff, own = {}, {}
    for key, a, b in pairs:
        rel = ((interior(a) - interior(b)).abs() / scale).double()
        diff[key] = (float((rel < SMR_PATH_TOL[0]).double().mean()),
                     float(rel.max()))
        own[key] = change_diff(a, b, init[key])
        if not (diff[key][0] > 0.95 and diff[key][1] < SMR_PATH_TOL[1]):
            raise AssertionError(f"phase 28 {label}: kernel and plain path "
                                 f"apart in {key}: {diff[key]} of {scale}")
    rec.update(path_diff=diff, path_scale=scale, path_diff_own_scale=own)
    return rec


def rk4_window(torch, kernels):
    """The RK4 blast's window, NCYC_WIN cycles (two batches, no inactive
    cycle: ROADMAP F32's RK3/RK4 note): the graph path one capture
    replayed a batch with A 4 a cycle (64 a capture) and every kernel's
    launches replays x the capture's, bitwise the eager window, which is
    within phase 26's path tiers of the per-cycle loop."""
    runs = {p: window_run(torch, kernels, "blast", NCYC_WIN, p, extra=RK4)
            for p in ("eager", "loop", "graph")}
    graph, w = runs["graph"], runs["graph"]["window"]
    per = graph["per_capture"] or {}
    if not (w["graph"] and w["captures"] == 1
            and w["replays"] == w["batches"] == NCYC_WIN // 16
            and per.get("mega_stage_v2") == 4 * 16):
        raise AssertionError(f"phase 28 window: {w}, a capture {per}")
    if {k: w["launches"].get(k, 0) for k in per} != \
            {k: w["replays"] * n for k, n in per.items()}:
        raise AssertionError(f"phase 28 window: launches {w['launches']}, "
                             f"{w['replays']} replays of {per}")
    window_same(graph, runs["eager"], "phase 28 RK4 window graph vs eager")
    tiers = window_tiers(torch, runs["eager"], runs["loop"],
                         "phase 28 RK4 window vs loop")
    return {"window": w, "per_capture": {k: v for k, v in per.items() if v},
            "vs_loop_f32": tiers}


def rk4_checks(torch, kernels, card):
    """Phase 28's untimed checks (a lane): the 124^3 blast under RK4 on
    both paths through the CLI (the per-cycle loop; A 4 a cycle, B 1 a
    stage), its window against the loop, the SR blast under RK4 on both
    paths (C and D 4 a cycle) and in its window, which stays eager (the
    Illinois c2p reads the host)."""
    res = {"blast": rk4_paths(
        torch, kernels, "blast", DECK, NCYC_RK4,
        lambda n: {"mega_stage_v2": 4 * n,
                   "periodic_fill_cc": 4 * n + BLAST_FILLS,
                   "periodic_fill_fc": 4 * n + BLAST_FILLS})}
    res["window"] = rk4_window(torch, kernels)
    with tempfile.TemporaryDirectory() as tmp:
        sr_deck = os.path.join(tmp, "sr_blast.athinput")
        with open(sr_deck, "w") as f:
            f.write(SR_DECK)
        res["sr_blast"] = rk4_paths(
            torch, kernels, "sr_blast", sr_deck, NCYC_RK4_SR,
            lambda n: {"fused_stage3d": 4 * n, "fused_ct3d": 4 * n,
                       "periodic_fill_cc": 4 * n + 1,
                       "periodic_fill_fc": 4 * n + 1})
    # the SR blast's window under RK4 stays eager (its Illinois c2p
    # reads the host), C and D 4 a cycle there too
    sr = window_run(torch, kernels, "sr_blast", NCYC_RK4_SR, "graph",
                    extra=RK4)
    w = sr["window"]
    got = {k: sr["launches"][k] for k in ("fused_stage3d", "fused_ct3d")}
    if w["graph"] or w["captures"] or "Illinois" not in (w["closed"] or "") \
            or got != {k: 4 * sr["ncycle"] for k in got}:
        raise AssertionError(f"phase 28 sr_blast window: {w}, {got}")
    res["sr_window"] = {"window": w, "launches": got}
    print(f"phase 28: [{card}] RK4 checks {res}")
    return res


def phase_rk4(torch, kernels, card):
    """Phase 28's timings (the main process): the 124^3 blast's
    zone-cycles/s under RK2 and RK4 on the kernel path, the per-cycle
    loop in turns (NCYC_RK4 cycles after a warm-up) and the graphed
    window (NCYC_WIN_TIME cycles after a captured batch)."""
    rates = {}
    for integ in ("rk2", "rk4", "rk2", "rk4"):
        rates.setdefault(f"{integ} loop", []).append(timed_cycles(
            torch, "true", DECK, NCYC_RK4, [f"time/integrator={integ}"]))
    for integ in ("rk2", "rk4"):
        r = window_rate(torch, kernels, "blast", "graph",
                        [f"time/integrator={integ}"])
        rates[f"{integ} graph"] = [r["zcps"]]
        rates[f"{integ} graph launches"] = r["launches"]
    print(f"phase 28: [{card}] blast zone-cycles/s {rates}")
    return rates


# ---------------------------------------------------------------------------
# phase 29: kernel H's matter source, on the coupled TOV's Z4c state and
# the fluid's stress-energy
# ---------------------------------------------------------------------------
def matter_state(torch, deck, extra):
    """The coupled deck built on the card, every leaf on level 1 (and so
    one inverse spacing for every block, ``inverse_spacing``: it raises
    where a block's differs), initialised and one coupled cycle on: its
    Z4c physics, the Z4c state before the cycle (the register) and after
    it, set_tmunu's channels of the state after it (the dict, and the
    ten channels stacked as the wrapper stacks them, to time the launch
    alone) and dt."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import z4c_stage as zs
    mesh, phys, _, driver, st = build(pin_for(extra, deck), device="cuda")
    levels = sorted(set(int(v) for v in mesh.mb_lev))
    if levels != [1]:
        raise AssertionError(f"phase 29 {deck}: leaves on levels {levels}")
    idx = zs.inverse_spacing(phys.z4c)
    st = driver.initialize(st)
    z0 = st["z"].clone()
    st, _, _ = driver.make_cycle_fn()(st, mesh.dt)
    dyn_finite(torch, st, "phase 29")
    tm = phys.set_tmunu(st["u"], st["w"], st["bcc"], phys.adm_of(st))
    mat = zs._stack_tmunu(tm)
    return {"z4c": phys.z4c, "mesh": mesh, "z0": z0,
            "z": st["z"].contiguous(), "tm": tm, "mat": mat, "dt": mesh.dt,
            "idx": idx, "levels": levels}


def matter_checks(torch, kernels, rec, tol):
    """H with and without the matter source against its plain version
    on the four RK4 stages of ``rec`` (``matter_state``), to ``tol`` of
    max(|value|, 1) on the interior (phase 10's tiers), each call with
    matter one launch of the matter instance; the source moves the
    stage.
    Returns the worst errors and the largest absolute one."""
    from athenak_tpu_torch.ops import z4c_stage as zs
    Z, z, z0 = rec["z4c"], rec["z"], rec["z0"]
    ng = Z.ng
    worst, err, moved = {"matter": 0.0, "vacuum": 0.0}, 0.0, 0.0
    sets = rk4_sets(torch, z.dtype, rec["dt"])
    n0 = kernels.Z4C_STAGE_MATTER.launches
    for g0, g1, bdt in sets:
        got = {}
        for kind, t in (("matter", rec["tm"]), ("vacuum", None)):
            got[kind] = zs.fused_z4c_stage(z, z0, Z, g0, g1, bdt, tmunu=t)
            want = zs.fused_z4c_stage_plain(z, z0, Z, g0, g1, bdt, tmunu=t)
            torch.cuda.synchronize()
            a = interior(got[kind], ng).double()
            b = interior(want, ng).double()
            rel = float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
            if not rel <= tol:             # NaN fails too
                raise AssertionError(f"phase 29 z4c_stage {kind}: {rel:g} "
                                     f"> {tol:g}")
            worst[kind] = max(worst[kind], rel)
            if kind == "matter":
                err = max(err, float((a - b).abs().max()))
        moved = max(moved, float((interior(got["matter"], ng)
                                  - interior(got["vacuum"], ng))
                                 .abs().max()))
    if kernels.Z4C_STAGE_MATTER.launches - n0 != len(sets):
        raise AssertionError("phase 29: the matter instance launched "
                             f"{kernels.Z4C_STAGE_MATTER.launches - n0} "
                             f"times in {len(sets)} calls")
    if not moved > 0.0:
        raise AssertionError("phase 29: the matter source moved nothing")
    return {"worst": worst, "max_abs_err": err, "moved": moved}


def matter_f64(torch, kernels, card):
    """Phase 29's float64 checks (a lane): the shipped tov_z4c_smr deck
    (64 blocks of 24^3 on level 1, ng 4), H with and without matter
    against its plain version to 1e-10."""
    rec = matter_state(torch, DYN_SHIPPED["tov_z4c_smr"],
                       ["job/precision=double"])
    res = matter_checks(torch, kernels, rec, 1e-10)
    res.update(blocks=rec["mesh"].nmb_total, levels=rec["levels"])
    print(f"phase 29: [{card}] H with matter, tov_z4c_smr f64: {res}")
    return res


def phase_matter(torch, kernels, card):
    """Phase 29 (the main process): DYN_WIDE (64 blocks of 32^3 on level
    1, ng 4, f32) after one coupled cycle; H with and without the matter
    source against its plain version on the four RK4 stages (2e-5 of
    max(|value|, 1)), the matter call one device launch (profiled), its
    CUDA-event ms (the launch on the stacked channels) beside the
    vacuum call's on the same state and the wrapper's with the dict
    (the stacking included), the plain stage's ms,
    the eager RHS with matter that the dyngr stage runs now
    (``Z4c._matter_rhs``) and the bound from bytes and operations."""
    from athenak_tpu_torch.ops import z4c_stage as zs
    rec = matter_state(torch, DYN_SHIPPED["tov_z4c_smr"], DYN_WIDE)
    kernels.reset_counts()
    res = matter_checks(torch, kernels, rec, 2e-5)
    # the matter instance's launches in the stage calls of the checks
    res["launches"] = kernels.Z4C_STAGE_MATTER.launches
    Z, z, z0, mat, tm = (rec[k] for k in ("z4c", "z", "z0", "mat", "tm"))
    args = (z, z0, Z) + rk4_sets(torch, z.dtype, rec["dt"])[1]
    split = one_launch_split(
        torch, lambda: zs._launch_stage(*args, mat), 20, "z4c_stage_matter")
    res.update({
        "ms": cuda_ms(lambda: zs._launch_stage(*args, mat), 20),
        "vacuum_ms": cuda_ms(lambda: zs.fused_z4c_stage(*args), 20),
        "call_ms": cuda_ms(lambda: zs.fused_z4c_stage(*args, tmunu=tm), 20),
        "plain_ms": cuda_ms(
            lambda: zs.fused_z4c_stage_plain(*args, tmunu=tm), 2),
        "matter_rhs_ms": cuda_ms(lambda: Z._matter_rhs(z, tm), 3),
        "device_us": split_us(split, 20),
        "bound": z4c_bound(Z, z, matter=True),
        "vacuum_bound": z4c_bound(Z, z),
        "blocks": rec["mesh"].nmb_total, "levels": rec["levels"],
        "inverse_spacing": rec["idx"]})
    print(f"phase 29: [{card}] H with matter on DYN_WIDE "
          f"({res['blocks']} blocks, levels {res['levels']}): "
          f"{res['ms']:.4f} ms (the wrapper with the dict {res['call_ms']:.4f}"
          f"; device {fmt_us(res['device_us'])}), vacuum "
          f"{res['vacuum_ms']:.4f} ms, bound {res['bound'][0]:.4f} ms "
          f"({res['bound'][1]}; vacuum {res['vacuum_bound'][0]:.4f}), "
          f"plain {res['plain_ms']:.2f} ms, the eager RHS with matter "
          f"{res['matter_rhs_ms']:.2f} ms; worst scale-relative errors "
          f"{res['worst']}, max abs {res['max_abs_err']:.3e}; launches "
          f"in the checks' stage calls {res['launches']}")
    return res


# the longest run, the 64-cell linear wave's launch-bound cycles, alone;
# the others dealt out so that no lane outlasts it (seconds a run beside
# phases 13-22 on an NVIDIA H100 80GB HBM3 at 700 W: lwave64 375; lwave32
# 219, shard_checks 266, window_checks 230, outputs_decks 206,
# split_gather 126, be 114, dyn_bars 108, the rest 2-46)
LANES = (("lwave64",),
         ("lwave32", "diffusion_bars", "jeans_bars", "binary_bars",
          "hohlraum_bar", "relax_bars", "shadow_bar", "diffusion_bar",
          "beam_bar", "epicycle_bar", "drag_bars"),
         ("shard_checks", "slice_restart", "amr_restart", "bbh_restart",
          "gr_restart", "gr_bars"),
         ("outputs_decks", "outputs_split", "shwave_bar"),
         # -p in a fresh process (late in a long one the profiler drops
         # records), then phase 27's checks
         ("outputs_profile", "split_gather", "dyn_bars", "be"),
         ("window_checks", "mri3d_bar", "rk4_checks", "matter_f64"))
LANE_TIMEOUT = 1100


def lane_parts():
    """The runs a lane may make: name -> fn(torch, kernels, card), whose
    result is JSON."""
    return {"lwave32": lambda t, k, c: lwave_run(32),
            "lwave64": lambda t, k, c: lwave_run(64),
            "epicycle_bar": lambda t, k, c: epicycle_bar(t, c),
            "shwave_bar": lambda t, k, c: shwave_bar(t, c),
            "mri3d_bar": lambda t, k, c: mri3d_bar(t, c),
            "drag_bars": lambda t, k, c: drag_bars(t, c),
            "be": be_runs,
            "diffusion_bars": diffusion_bars,
            "jeans_bars": jeans_bars,
            "binary_bars": lambda t, k, c: binary_bars(t, c),
            "hohlraum_bar": lambda t, k, c: hohlraum_bar(t),
            "relax_bars": lambda t, k, c: relax_bars(t),
            "shadow_bar": lambda t, k, c: shadow_bar(t),
            "diffusion_bar": lambda t, k, c: diffusion_bar(t),
            "beam_bar": lambda t, k, c: beam_bar(t),
            "dyn_bars": dyn_bars,
            "slice_restart": slice_restart,
            "amr_restart": lambda t, k, c: amr_restart(t, k),
            "bbh_restart": lambda t, k, c: bbh_restart(t, k),
            "gr_restart": lambda t, k, c: gr_restart(t, k),
            "gr_bars": lambda t, k, c: gr_bars(t, k),
            "shard_checks": shard_checks,
            "outputs_decks": outputs_decks,
            "outputs_split": outputs_split,
            "outputs_profile": outputs_profile,
            "window_checks": window_checks,
            "split_gather": split_gather,
            "rk4_checks": rk4_checks,
            "matter_f64": matter_f64,
            # phase 27's timings alone, and on a machine of several
            # cards its nccl runs: python3 chip_smoke.py --lane
            # phase_split_gather
            "phase_split_gather": phase_split_gather,
            # phase 24's timings alone, and on a machine of several
            # cards its nccl runs: python3 chip_smoke.py --lane phase_shard
            "phase_shard": phase_shard}


def _json_scalar(obj):
    """numpy and torch values as JSON (their lists or scalars)."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


def lane_main(names) -> int:
    """A lane: the named runs one after the other on the card, their
    results and seconds as the last line of standard output."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from athenak_tpu_torch import kernels
    os.environ["ATHENAK_DEVICE"] = "cuda"
    card = smi()
    parts = lane_parts()
    out, seconds = {}, {}
    for name in names:
        t = time.perf_counter()
        out[name] = parts[name](torch, kernels, card)
        seconds[name] = time.perf_counter() - t
        torch.cuda.empty_cache()   # the card is shared with the others
    print(json.dumps({"lane": out, "seconds": seconds},
                     default=_json_scalar))
    return 0


def _die_with_parent():
    """A lane's pre-exec hook: Linux kills it when this process dies
    (``PR_SET_PDEATHSIG``), so no lane outlives a killed run."""
    import ctypes
    import signal
    ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)


def lanes_start():
    """A child process on the card for every lane of LANES; their output
    goes to files (a pipe would fill and stall them)."""
    lanes = []
    for names in LANES:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        lanes.append((names, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--lane", *names],
            stdout=out, stderr=err, text=True, preexec_fn=_die_with_parent,
            env=dict(os.environ, ATHENAK_DEVICE="cuda")), out, err))
    return lanes


def lanes_kill(lanes):
    for _, proc, _, _ in lanes:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def lanes_finish(lanes):
    """Wait for every lane, print its lines; raise if one failed (the
    others killed).  Returns every run's result by name, and the
    seconds of each under "seconds"."""
    got, seconds = {}, {}
    try:
        for names, proc, out, err in lanes:
            proc.wait(timeout=LANE_TIMEOUT)
            out.seek(0)
            lines = out.read().splitlines()
            for line in lines[:-1]:
                print(line)
            if proc.returncode != 0 or not lines \
                    or not lines[-1].startswith('{"lane"'):
                err.seek(0)
                raise AssertionError(f"lane {names}: exit "
                                     f"{proc.returncode}\n"
                                     f"{err.read()[-3000:]}")
            rec = json.loads(lines[-1])
            got.update(rec["lane"])
            seconds.update(rec["seconds"])
    finally:
        lanes_kill(lanes)
    print(f"lanes: seconds a run {seconds}")
    return dict(got, seconds=seconds)


def merge_lanes(card, lanes, slice_, amr, bbh, gr, grav, sbox, rad):
    """The lanes' results into their phases' records."""
    res = lanes["slice_restart"]
    slice_["restart"] = res
    slice_["launches"].update({f"restart {k} {r}": v[r]
                               for k, v in res.items()
                               for r in ("straight", "resumed")})
    amr["restart"] = lanes["amr_restart"]
    bbh["restart"] = lanes["bbh_restart"]
    gr["restart"] = lanes["gr_restart"]
    gr.update(lanes["gr_bars"])
    gr["runs"].update({k: gr[k] for k in lanes["gr_bars"]})
    grav.update(diffusion=lanes["diffusion_bars"],
                binary_gravity=lanes["binary_bars"], be=lanes["be"])
    grav["jeans"]["bars"] = lanes["jeans_bars"]
    grav["runs"] = grav_runs(grav)
    sbox["bars"] = {"epicycle": lanes["epicycle_bar"],
                    "mhd_shwave": lanes["shwave_bar"],
                    "mri3d": lanes["mri3d_bar"],
                    "drag": lanes["drag_bars"]}
    rad["bars"].update({"hohlraum": lanes["hohlraum_bar"],
                        "relax": lanes["relax_bars"],
                        "shadow": lanes["shadow_bar"],
                        "diffusion": lanes["diffusion_bar"],
                        "beam_kerr": lanes["beam_bar"],
                        "lwave": lwave_bar(lanes)})
    print(f"phase 20: [{card}] the bars {grav['diffusion']}, "
          f"{grav['jeans']['bars']}, {grav['binary_gravity']}")
    print(f"phase 21: [{card}] the JAX tests' bars on the card "
          f"{sbox['bars']}")
    print(f"phase 22: [{card}] the JAX tests' bars on the card "
          f"{rad['bars']}")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 bound_, library_ms):
    return {"name": name, "route": "cuda",
            "source": f"athenak_tpu_torch/csrc/{source}",
            "replaces": f"athenak_tpu/ops/{replaces}",
            "launches": sum(launches.values()),
            "launches_by_path": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_[0],
            "bound_by": bound_[1], "library_ms": library_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from athenak_tpu_torch import kernels
    from athenak_tpu_torch.ops import fill

    card = smi()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    kernels.library()
    seconds = {"1": time.perf_counter() - t0}
    print(f"phase 1: kernels built and loaded in {seconds['1']:.1f} s "
          f"({kernels.BUILD_INFO['path']}); seconds a source, all started "
          f"together: {kernels.BUILD_INFO.get('source_seconds')}")
    for line in ptxas_summary(kernels.BUILD_INFO.get("log", "")):
        print("  ptxas:", line)

    def phase(label, fn, *args):
        import gc
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t
        # hand the phase's cached blocks back to the card, which the
        # lanes and phase 24's ranks share with this process (the
        # drivers it dropped first: a driver holds its window's capture)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        sr_deck = os.path.join(tmp, "sr_blast.athinput")
        turb_deck = os.path.join(tmp, "turb.athinput")
        pool_deck = os.path.join(tmp, "pool.athinput")
        z4c_deck = os.path.join(tmp, "z4c.athinput")
        for path, text in ((sr_deck, SR_DECK), (turb_deck, TURB_DECK),
                           (pool_deck, POOL_DECK), (z4c_deck, Z4C_DECK)):
            with open(path, "w") as f:
                f.write(text)
        fill_times, fill_errs = phase("2", phase_fill, torch, fill, card)
        stage_res = phase("3", phase_stage, torch, card, pool_deck)
        launches, rates = phase("4", phase_main, torch, kernels, card)
        split_res = phase("5", phase_split, torch, card, sr_deck)
        sr_launches, sr_rates = phase("6", phase_sr_main, torch, kernels,
                                      card, sr_deck)
        v1_res = phase("7a", phase_mega_v1, torch, card)
        aux_res = phase("7b", phase_aux, torch, card)
        pool_res = phase("8", phase_pool_fill, torch, card, turb_deck,
                         pool_deck)
        turb = phase("9", phase_turb_main, torch, kernels, card, turb_deck,
                     pool_deck)
        z4c_res = phase("10", phase_z4c_stage, torch, card, z4c_deck)
        z4c = phase("11", phase_z4c_main, torch, kernels, card, z4c_deck)
        flux_res = phase("12", phase_flux_dir, torch, card)
        # DYN_WIDE's rates before the lanes start; the runs that time
        # nothing go to the lanes, beside phases 13-22
        wide = phase("23 dyn_wide", phase_dyn_wide, torch, kernels, card)
        # phase 29's and 28's timings on a quiet card, before the lanes
        matter = phase("29", phase_matter, torch, kernels, card)
        rk4 = phase("28", phase_rk4, torch, kernels, card)
        lanes = lanes_start()
        try:
            smr = phase("13", phase_smr_main, torch, kernels, card)
            hydro = phase("14", phase_hydro_main, torch, kernels, card)
            tail, tail_flux = phase("15", phase_tail_main, torch, kernels,
                                    card)
            slice_ = phase("16", phase_slice, torch, kernels, card)
            amr = phase("17", phase_amr, torch, kernels, card)
            bbh = phase("18", phase_bbh, torch, kernels, card, fill)
            gr = phase("19", phase_gr, torch, kernels, card)
            grav = phase("20", phase_grav, torch, kernels, card)
            sbox = phase("21", phase_sbox, torch, kernels, card)
            rad = phase("22", phase_rad, torch, kernels, card)
            got = phase("lanes (the wait after 22)", lanes_finish, lanes)
        finally:
            lanes_kill(lanes)
        shard = phase("24", phase_shard, torch, kernels, card)
        write_ms = phase("25", phase_outputs, torch, kernels, card)
        win = phase("26", phase_window, torch, kernels, card)
        gather = phase("27", phase_split_gather, torch, kernels, card)
    shard["checks"] = got["shard_checks"]
    gather["checks"] = got["split_gather"]
    rk4 = {"rates": rk4, "checks": got["rk4_checks"]}
    matter["f64"] = got["matter_f64"]
    outs = {"decks": got["outputs_decks"], "split": got["outputs_split"],
            "profile": got["outputs_profile"], "write_ms": write_ms}
    merge_lanes(card, got, slice_, amr, bbh, gr, grav, sbox, rad)
    dyn = dict(got["dyn_bars"], wide=wide)
    seconds["lanes"] = got["seconds"]
    print(f"seconds a phase: {seconds}")

    def runs(name):
        return {"blast": launches[name], "sr_blast": sr_launches[name],
                **{k: v["launches"][name] for k, v in turb.items()},
                **{k: v["launches"][name] for k, v in z4c.items()},
                **{k: v["launches"][name] for k, v in smr.items()},
                **{k: v["launches"].get(name, 0) for k, v in hydro.items()},
                **{k: v["launches"].get(name, 0) for k, v in tail.items()},
                **{k: v.get(name, 0)
                   for k, v in slice_["launches"].items()},
                **{k: v["launches"].get(name, 0)
                   for k, v in amr["runs"].items()},
                **{k: v["launches"].get(name, 0)
                   for k, v in bbh["runs"].items()},
                **{k: v["launches"].get(name, 0)
                   for k, v in gr["runs"].items()},
                **{k: v.get(name, 0) for k, v in grav["runs"].items()},
                **{k: v.get(name, 0) for k, v in sbox["runs"].items()},
                **{k: v.get(name, 0) for k, v in rad["runs"].items()},
                **{f"{k} shipped": v["launches"].get(name, 0)
                   for k, v in dyn["shipped"].items()},
                **{k: v["launches"].get(name, 0)
                   for k, v in dyn["wide"].items() if "launches" in v},
                "dyn_restart": dyn["restart"]["resumed"].get(name, 0),
                "bbh_restart": bbh["restart"]["resumed"].get(name, 0),
                **{f"shard {k} rank {r}": lr.get(name, 0)
                   for k, v in shard["checks"].items()
                   if isinstance(v, dict)
                   for r, lr in enumerate(v["launches_by_rank"])},
                **{f"gather {k} rank {r}": lr.get(name, 0)
                   for k, v in gather["checks"].items()
                   if isinstance(v, dict)
                   for r, lr in enumerate(v["launches_by_rank"])},
                **{f"outputs {k}": v["launches"].get(name, 0)
                   for k, v in outs["decks"].items()},
                "outputs -p blast": outs["profile"]["launches"].get(name, 0),
                **{f"window {k} {p}": r["launches"].get(name, 0)
                   for k, v in win.items() for p, r in v.items()},
                **{f"rk4 {k}": rk4["checks"][k]["true"]["launches"].get(
                    name, 0) for k in ("blast", "sr_blast")},
                "rk4 window blast graph":
                    rk4["checks"]["window"]["window"]["launches"].get(name,
                                                                     0)}

    ft, fe = fill_times, fill_errs
    zr = z4c_res["res"]["60^3 ng 2"]
    print(json.dumps({"kernels": [
        kernel_entry("mega_stage_v2", "mega_stage_v2.cu",
                     "pallas_stage.py:823", runs("mega_stage_v2"),
                     max(stage_res["max_abs_err"],
                         amr["checks"]["flat"]["stage_err"]),
                     stage_res["ms"],
                     stage_res["plain_ms"], stage_res["bound"], None),
        kernel_entry("periodic_fill_cc", "periodic_fill.cu",
                     "pallas_fill.py:68", runs("periodic_fill_cc"),
                     fe["periodic_fill_cc"], *ft["periodic_fill_cc"][:2],
                     ft["periodic_fill_cc"][3], ft["periodic_fill_cc"][2]),
        kernel_entry("periodic_fill_fc", "periodic_fill.cu",
                     "pallas_fill.py:89", runs("periodic_fill_fc"),
                     fe["periodic_fill_fc"], *ft["periodic_fill_fc"][:2],
                     ft["periodic_fill_fc"][3], ft["periodic_fill_fc"][2]),
        kernel_entry("fused_stage3d", "fused_stage.cu",
                     "pallas_stage.py:191", runs("fused_stage3d"),
                     split_res["fused_stage3d"]["max_abs_err"],
                     split_res["fused_stage3d"]["ms"],
                     split_res["fused_stage3d"]["plain_ms"],
                     split_res["fused_stage3d"]["bound"], None),
        kernel_entry("fused_ct3d", "fused_ct.cu", "pallas_stage.py:382",
                     runs("fused_ct3d"),
                     split_res["fused_ct3d"]["max_abs_err"],
                     split_res["fused_ct3d"]["ms"],
                     split_res["fused_ct3d"]["plain_ms"],
                     split_res["fused_ct3d"]["bound"], None),
        kernel_entry("mega_stage_v1", "mega_stage_v1.cu",
                     "pallas_stage.py:576", runs("mega_stage_v1"),
                     v1_res["max_abs_err"], v1_res["ms"],
                     v1_res["plain_ms"], v1_res["bound"], None),
        kernel_entry("fused_aux3d", "fused_aux.cu", "pallas_stage.py:1129",
                     runs("fused_aux3d"), aux_res["max_abs_err"],
                     aux_res["ms"], aux_res["plain_ms"], aux_res["bound"],
                     None),
        kernel_entry("pool_fill", "pool_fill.cu", "pallas_pool_fill.py:221",
                     runs("pool_fill"),
                     max(pool_res["max_abs_err"],
                         amr["checks"]["flat"]["fill_err"]),
                     pool_res["ms"], pool_res["plain_ms"], pool_res["bound"],
                     pool_res["library_ms"]),
        kernel_entry("z4c_stage", "z4c_rhs.cuh", "pallas_z4c.py:384",
                     runs("z4c_stage"), z4c_res["max_abs_err"], zr["ms"],
                     zr["plain_ms"], zr["bound"], None),
        # the matter source: no CLI path launches it (its gate is the
        # JAX package's, tmunu closes it), phase 29 calls it directly
        kernel_entry("z4c_stage_matter", "z4c_rhs.cuh", "pallas_z4c.py:384",
                     {"every CLI path": sum(runs("z4c_stage_matter")
                                            .values()),
                      "phase 29 stage calls": matter["launches"]},
                     matter["max_abs_err"], matter["ms"],
                     matter["plain_ms"], matter["bound"], None),
        kernel_entry("z4c_outflow_fill", "z4c_stage.cu", "pallas_z4c.py:533",
                     runs("z4c_outflow_fill"), z4c_res["fill_max_abs_err"],
                     zr["fill"]["ms"], zr["fill"]["plain_ms"],
                     zr["fill"]["bound"], zr["fill"]["library_ms"]),
        kernel_entry("fused_flux_dir", "flux_dir.cu", "pallas_flux.py:92",
                     runs("fused_flux_dir"), flux_res["max_abs_err"],
                     flux_res["ms"], flux_res["plain_ms"], flux_res["bound"],
                     None),
    ], "zone_cycles_per_s": {"kernel": rates["true"],
                             "plain": rates["false"],
                             "sr_kernel": sr_rates["true"],
                             "sr_plain": sr_rates["false"],
                             **{f"{k}_kernel": v["rates"]["true"]
                                for k, v in turb.items()},
                             **{f"{k}_plain": v["rates"]["false"]
                                for k, v in turb.items()},
                             **{f"{k}_kernel": v["rates"]["true"]
                                for k, v in z4c.items()},
                             **{f"{k}_plain": v["rates"]["false"]
                                for k, v in z4c.items()},
                             **{f"{k}_kernel": v["rates"]["true"]
                                for k, v in smr.items()},
                             **{f"{k}_plain": v["rates"]["false"]
                                for k, v in smr.items()},
                             **{f"{k}_{p}": v["rates"][u]
                                for k, v in {**hydro, **tail}.items()
                                for p, u in (("kernel", "true"),
                                             ("plain", "false"))}},
        "cycle_parts_ms": {k: v["parts"]
                           for k, v in {**turb, **z4c, **smr,
                                        **hydro}.items()},
        "tail_path_diff": {k: v["path_diff"] for k, v in tail.items()},
        "amr": {"runs": {k: {kk: vv for kk, vv in v.items()}
                         for k, v in amr["runs"].items()},
                "checks": amr["checks"], "restart": amr["restart"]},
        "slice": {k: slice_[k] for k in ("turb_rates", "fofc", "restart",
                                         "turb60_poked_nfofc",
                                         "flux_dir_rt2d_mhd", "deck_zcps",
                                         "parts_ms")},
        "tail_stage_check": tail_flux["stage_check"],
        "flux_dir_bw": {"ms": tail_flux["ms"],
                        "plain_ms": tail_flux["plain_ms"],
                        "bound_ms": tail_flux["bound"][0],
                        "max_abs_err": tail_flux["max_abs_err"]},
        "flux_dir_ms": {deck: {d: r["ms"] for d, r in dirs.items()}
                        for deck, dirs in flux_res["by_deck"].items()},
        "flux_dir_plain_ms": {
            deck: {d: r["plain_ms"] for d, r in dirs.items()}
            for deck, dirs in flux_res["by_deck"].items()},
        "flux_dir_bound_ms": {deck: dirs["x1"]["bound"][0]
                              for deck, dirs in flux_res["by_deck"].items()},
        "smr_path_diff": {k: v["path_diff"] for k, v in smr.items()},
        "z4c_stage_ms": {k: v["ms"] for k, v in z4c_res["res"].items()},
        "z4c_stage_bound_ms": {k: v["bound"][0]
                               for k, v in z4c_res["res"].items()},
        "z4c_path_diff": {k: v["path_diff"] for k, v in z4c.items()},
        "mega_stage_v1_stage1_ms": v1_res["stage1_ms"],
        "mega_stage_v1_8x64_ms": v1_res["pool_ms"],
        "mega_stage_v2_8x62_ms": stage_res["pool_ms"],
        "fused_aux3d_nowrap_ms": aux_res["nowrap_ms"],
        "device_us": {
            "periodic_fill_cc": ft["periodic_fill_cc"][4],
            "periodic_fill_fc": ft["periodic_fill_fc"][4],
            "fused_aux3d": aux_res["device_us"],
            "fused_aux3d_nowrap": aux_res["nowrap_device_us"],
            "fused_ct3d": split_res["fused_ct3d"]["device_us"],
            **{f"z4c_outflow_fill {k}": v["fill"]["device_us"]
               for k, v in z4c_res["res"].items() if "fill" in v}},
        "pool_fill_fc_ms": pool_res["fc_ms"],
        "bbh": {"sor": bbh["bbh_flat"]["sor"],
                "bbh_flat_checks": bbh["bbh_flat"]["checks"],
                "awa_fill": bbh["awa"]["b"], "awa_stage": bbh["awa"]["h"],
                "ahf": bbh["ahf"],
                "runs": {k: {kk: v[kk] for kk in ("rates", "path_diff")
                             if kk in v} for k, v in bbh["runs"].items()}},
        "gr": {k: {kk: vv for kk, vv in v.items() if kk != "launches"}
               if isinstance(v, dict) else v
               for k, v in gr.items() if k != "runs"},
        "grav_diff": {k: v for k, v in grav.items() if k != "runs"},
        "sbox": {k: v for k, v in sbox.items() if k != "runs"},
        "rad": {k: v for k, v in rad.items() if k != "runs"},
        "dyn": {"shipped": {k: {kk: vv for kk, vv in v.items()
                                if kk != "launches"}
                            for k, v in dyn["shipped"].items()},
                "bars": dyn["bars"], "graphs": dyn["graphs"],
                "seconds": dyn["seconds"],
                "wide": {k: {kk: vv for kk, vv in v.items()
                             if kk != "launches"}
                         for k, v in dyn["wide"].items()}},
        "shard": shard,
        "split_gather": gather,
        "rk4": rk4,
        "matter": {k: v for k, v in matter.items()},
        "outputs": outs,
        "window": {"rates": {k: {p: {kk: vv for kk, vv in r.items()
                                     if kk != "launches"}
                                 for p, r in v.items()}
                             for k, v in win.items()},
                   "checks": got["window_checks"]},
        "sr_c2p_ms": split_res["c2p_ms"], "phase_seconds": seconds,
        "build_seconds": kernels.BUILD_INFO.get("source_seconds"),
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lane"]:
        sys.exit(lane_main(sys.argv[2:]))
    sys.exit(main())
