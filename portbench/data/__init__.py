"""The benchmark's data generators, one module a generator name
(``configs/<config>.json``'s ``data.generator``), each a frozen copy of a
data module of the port, made from the run's seed. Each exposes
``make(n_train, n_test, img_sz, seed)`` -> (training_x, training_y,
testing_x, testing_y) as numpy arrays."""
