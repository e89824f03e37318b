"""The port's shell surface: the AdvMix robustness demo, the int8-teacher
A/B and the reference's train / test / make_datasets wrappers, over the
port's entry points (`python -m advmix_tpu_torch.tools.*`). Counterpart of
the JAX package's `scripts/`."""
