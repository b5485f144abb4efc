"""Hand-written Hopper kernels and their plain torch versions (port of
src/repro/kernels). K1 / K1b `ams_matmul` (fp533 / planes containers), K2
`paged_attention_ams` and K3 `paged_attention_bf16`; `build` compiles
``csrc/*.cu`` with nvcc and loads them with ctypes."""
