"""The port's command line (`python -m tritonk8ssupervisor_tpu_torch.cli.main`)."""
