"""The entries: what one frame of a cell is (traffic "entry")."""
