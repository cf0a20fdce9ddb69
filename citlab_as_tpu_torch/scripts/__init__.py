"""The training and evaluation recipes that made ``models_ckpt/``, on the
port (``python -m citlab_as_tpu_torch.scripts.<name>``): each module has
the JAX repository script's name, flags and defaults, with ``--device``
(default cuda) in place of ``--platform``."""
