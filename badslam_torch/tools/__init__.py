"""The port's user tools, each run as ``python -m badslam_torch.tools.<name>``:
``evaluate_ate`` (the TUM ATE protocol), ``validate_sequence`` (a whole run
evaluated with it), ``train_vocabulary`` (a loop-detection vocabulary from
image sequences) and ``gen_cli_docs`` (the CLI's flag table). Counterparts
of the JAX package's ``tools/`` scripts of the same names."""
