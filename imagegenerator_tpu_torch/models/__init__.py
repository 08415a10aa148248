"""v1 models: conditioning augmentation, StackGAN generators, BERT."""
