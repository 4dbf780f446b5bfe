"""The benchmark's own arithmetic: peaks of the card, model flops and each
kernel's operations and bytes.  Frozen here so that a change to the
program cannot move the yardstick it is measured with."""
