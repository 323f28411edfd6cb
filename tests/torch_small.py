"""A small ``dynamic_swarm`` for the port's CPU tests: 16x16 images,
encoder 16/32/64, 2 scenes x 8 drifting robots (D 256, ELL width 8, a
tile-pair plan), the numpy renderer and graph builder. The same function
shrinks the JAX package's config and the port's."""

import dataclasses


def small(cfg, impl="auto", lr=1e-3, warmup=2, data=None, **train):
    data = dict(dict(image_size=(16, 16), num_robots=8, scenes_per_batch=2,
                     num_train_scenes=8, num_eval_scenes=4, renderer="numpy",
                     graph_builder="numpy"), **(data or {}))
    return cfg.replace(
        data=dataclasses.replace(cfg.data, **data),
        model=dataclasses.replace(cfg.model, image_size=(16, 16),
                                  encoder_channels=(16, 32, 64)),
        train=dataclasses.replace(cfg.train, learning_rate=lr,
                                  warmup_steps=warmup, steps=100, **train),
        parallel=dataclasses.replace(cfg.parallel, ops_impl=impl))
