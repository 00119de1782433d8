"""Command line:
`python -m deeplearning4j_tpu_torch.cli {train,test,predict,serve} ...`."""

from deeplearning4j_tpu_torch.cli.driver import main

__all__ = ["main"]
