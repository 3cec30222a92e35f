"""Command-line options of the port's train and eval CLIs: the JAX
package's flags (``dsgan_tpu/options``), with the same names, types and
defaults."""
