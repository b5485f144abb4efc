"""Hand-written Hopper kernels and their plain torch versions (port of
src/repro/kernels). K1 `ams_matmul` (fp533) and K2 `paged_attention_ams`;
`build` compiles ``csrc/*.cu`` with nvcc and loads them with ctypes."""
