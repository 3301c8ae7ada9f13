"""The share of a served batch in which no operation ran on the device:
`device.idle_share`'s reading (one minus the union of the device's
operation intervals in the traced batch, over the host wall of the same
batch served untraced just before it), under a name of its own since it
moves the LM cells' `tokens_per_s`."""
from dasbench.harness import reader

read = reader("device.idle_share")
