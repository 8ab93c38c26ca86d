"""PyTorch/CUDA port of ``rafiki_tpu`` for NVIDIA Hopper (H100).

The JAX package ``rafiki_tpu`` is the reference; this package mirrors its
file layout module by module (``rafiki_tpu_torch/ops/paged_attention.py``
ports ``rafiki_tpu/ops/paged_attention.py`` and so on), and every Pallas
kernel on a ported path becomes a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use.

Rules the port keeps:

- it imports ``torch`` and ``numpy`` (and scipy where the JAX advisors
  do), never ``jax``/``flax``/``optax`` and
  nothing from ``rafiki_tpu`` — what it needs of a JAX-free reference
  module it keeps as its own copy;
- entry points run on the CUDA card unless the caller passes
  ``device="cpu"`` (:func:`rafiki_tpu_torch.utils.device.resolve_device`);
- a kernel wrapper runs its plain PyTorch version only for tensors that
  lie on the CPU; a CUDA tensor launches the kernel or raises.

Slices ported so far: paged Llama serving (the decoder's decode branch,
the continuous-batching ``DecodeEngine`` over a paged KV pool, kernels
B1/B2); LoRA training of the Llama template (the flash-attention forward
and backward, B3/B5/B6); the ViT and BERT classifiers, serving and
training (the head-tiled forward B4 and the patch projection B7); int8
Llama serving; the inference worker; tuning (knobs, advisors, the meta
store, the train worker and ``tune_model``); the control plane (the
admin and its REST app, the services manager over CUDA device slots, the
advisor service, the kv data plane, the Predictor and the client SDK)
and its crash recovery (boot reconciliation and adoption, the kvd's
respawn with WAL replay, rolling restarts through the workers' obs
sidecars, the MetaStore backup and the workdir doctor); scale-out (the
routing pool, manual scale and the autoscaler, several slots on one
card), fault injection (``chaos/``, ``RAFIKI_CHAOS``) and the MetaStore's
Postgres adapter (``store/db.py``).
"""

__version__ = "0.1.0"
