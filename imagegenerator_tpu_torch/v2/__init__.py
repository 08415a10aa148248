"""v2: VQGAN+CLIP latent-optimization image generation — counterpart of
``imagegenerator_tpu/v2``. ``python -m imagegenerator_tpu_torch.v2.generate``
is the CLI."""
