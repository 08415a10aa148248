"""Stage-1/2 systems, the trainers, the EMA, and the training and sampling CLIs."""
