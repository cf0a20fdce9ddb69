"""Training of the port's nets (port of ``citlab_as_tpu/train/``): the
ARU-Net segmentation trainer and the relation-GNN trainer, their
optimizers, checkpoints, input pipelines and LAV."""
