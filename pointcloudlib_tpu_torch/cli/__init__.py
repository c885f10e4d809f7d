"""The training CLIs (counterparts of the repository's ``train_cls.py`` and
``train_partseg.py``):

    python -m pointcloudlib_tpu_torch.cli.train_cls --model pointnet2
    python -m pointcloudlib_tpu_torch.cli.train_partseg --model dgcnn

Both run on the card unless ``--device cpu`` is passed."""
