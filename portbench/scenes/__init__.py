"""Scene generators, one module a generator, named as a configuration's
``"generator"`` key names it and found by that name: ``build(config)``
returns the scene as plain data (``portbench.scenegen.SceneSpec``)."""
