"""repro_torch: the PyTorch/CUDA port of `repro` for NVIDIA Hopper.

It sits beside the JAX package and imports neither JAX nor `repro`.  Every
Pallas kernel on a ported path becomes a hand-written CUDA kernel
(`repro_torch.kernels`); the plain PyTorch version of each kernel sits
beside it and is what runs when the tensors lie on the CPU.

Entry points (`models.model.lm_init`, `serve.engine.PagedEngine`,
`serve.scheduler.Scheduler`, `launch.serve`) run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
