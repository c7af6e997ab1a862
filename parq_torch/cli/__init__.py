"""The port's twins of train.py and eval.py:

    python -m parq_torch.cli.train --cfg configs/train.yaml [KEY VALUE ...]
    python -m parq_torch.cli.eval --cfg configs/eval.yaml [--CHECKPOINT_PATH p]
"""
