"""Device operators of the port: plain functions on torch tensors, each
hand-written kernel beside its plain PyTorch version."""

# Session-wide dictionary id for expression-produced text (the
# reference's ops/expr.py LITERAL_DICT); the analyzer names it when it
# types computed text.
LITERAL_DICT = "__lit__"
