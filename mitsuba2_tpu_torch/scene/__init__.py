"""Host scene build, presets and the traversal dispatch of the port."""
