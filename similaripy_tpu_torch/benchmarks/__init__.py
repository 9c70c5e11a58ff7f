"""The port's hardware probes and benchmark scripts: the transposed-lhs
product (P1) and the int8/int4 rate probe (P2) with their wrappers
(``probes``), the kernel-check sweep (``kernel_check``), the
microbenchmarks ``micro_int4`` and ``micro_tile_kernel``, and
``tlhs_transpose_cost``, which times P1's int8 kernel against a build of
it with the in-register transpose compiled out."""
