"""Command-line tools of the port that are not entry points of the
system: ``profile_opclass`` (device time by class of kernel) and
``validate_real_weights`` (the weights-day playbook)."""
