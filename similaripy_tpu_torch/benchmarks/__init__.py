"""The port's benchmark entry points, hardware probes and benchmark scripts:
the headline benchmark (``bench``), the benchmark suite (``run_benchmarks``
over ``benchmark`` and ``dataset_loaders``, with ``compare_benchmarks`` and
the regression gate ``bench_gate``), the kernel stamp (``kernel_stamp``)
that the kernel-check sweep (``kernel_check``) writes and ``bench`` checks,
the transposed-lhs product (P1) and the int8/int4 rate probe (P2) with their
wrappers (``probes``), the microbenchmarks ``micro_int4`` and
``micro_tile_kernel``, and ``tlhs_transpose_cost``, which times P1's int8
kernel against a build of it with the in-register transpose compiled out."""
