"""The benchmark's scenes, one module a scene generator, found by the
`scene` name of a configuration file (gpubench/configs/<config>.json)."""
