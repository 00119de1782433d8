"""Command line:
`python -m deeplearning4j_tpu_torch.cli {train,test,predict,serve} ...`."""
