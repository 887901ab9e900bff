"""Benchmarks of the port.

- containerbench.py — the reference's own VM-level workloads (1 GiB disk
  write, md5 over 256 MiB; reference docs/benchmarks.md:8-12), host
  numbers comparable against its published ones.
- resnet50.py, lm.py, decode.py — training throughput of ResNet-50 (and
  the ViT) and of the LM, and decode and serving throughput, on one card
  or a mesh of ranks.
"""
