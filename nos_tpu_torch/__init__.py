"""PyTorch/CUDA port of the nos_tpu workload plane.

The JAX package ``nos_tpu`` stays the reference; this package mirrors its
module paths and function names (the counterpart of
``nos_tpu/X/y.py::f`` is ``nos_tpu_torch/X/y.py::f``) and holds every
Pallas kernel's counterpart as a kernel written by hand for Hopper
(``csrc/``). It imports ``torch`` and ``numpy`` only: nothing of JAX and
nothing of ``nos_tpu``, whose host-side pieces it copies where it needs
them.

Slices ported so far:

- single-device serving through the paged KV cache, greedy or sampled
  per request (``cmd.server.build_engine`` ->
  ``models.serving.DecodeServer`` -> ``models.generate.forward_paged``
  -> ``ops.attention.paged_decode_attention``), and the generate binary
  (``cmd.generate``);
- training (``cmd.trainer.train`` ->
  ``models.transformer.make_train_step`` / ``loss_fn`` / ``forward`` ->
  ``ops.attention.attention``, with ``train.optim``, whose adamw runs
  ``csrc/adamw.cu``, and ``train.data``), and its ``dp``/``fsdp``/``tp``
  layouts, one process a rank over ``torch.distributed``
  (``parallel.mesh.TrainMesh``, ``parallel.launch``);
- ``utils.prng``: the parts of ``jax.random`` the reference draws from
  (threefry), bit for bit, so seeds give the reference's streams.
"""
