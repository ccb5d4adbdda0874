"""Training stack of the port: losses, optimizer and freezing, checkpoints,
the train step and loop, the synthetic scene generator, flow readers,
augmenters, datasets, validation and logging.

Port of ``mft_tpu/train`` (reference MFT/RAFT/train.py, core/datasets.py,
core/utils/augmentor.py). The official MFT recipe finetunes only the
occlusion and uncertainty block on a frozen RAFT (``train_params.txt``); full
RAFT training, with gradients through the lookup's backward kernel into both
encoders, is supported as well.
"""
