"""repro_torch.checkpoint — atomic, rotated, differential checkpoints
(the port of ``repro.checkpoint``; a step directory written by either
package restores in the other)."""
