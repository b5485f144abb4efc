"""Hand-written Hopper kernels and their plain torch versions (port of
src/repro/kernels). K1 / K1b `ams_matmul` (fp533 / planes containers), K2
`paged_attention_ams`, K3 `paged_attention_bf16`, K4 `contiguous_attention`
and K5 `contiguous_attention_mla`; `build` compiles ``csrc/*.cu`` with nvcc
and loads them with ctypes; `tuning` holds the reference's contiguous
key-block plan."""
