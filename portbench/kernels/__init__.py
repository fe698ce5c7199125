"""Operation and byte counts of the port's kernels, one file per kernel op:
``NAMES`` (a regular expression over the device trace's kernel names),
``flops(**shape)`` and ``nbytes(**shape)``, each input counted as read
once and each output as written once."""
