"""Writes the committed TensorFlow fixtures `tests/data/torch_port/
tf_bundles/` and their `.npz` twins, with TensorFlow and the JAX package's
readers (on the CPU):

    JAX_PLATFORMS=cpu python -m tests.torch_port_tf_fixture

Four cases, each a directory and a twin `<case>.npz`:

- `tf1/`: a `tf.compat.v1.train.Saver` checkpoint (relative paths in its
  `checkpoint` file, so the directory resolves wherever it lies):
  variables of every numeric dtype the port reads, automl-style
  ExponentialMovingAverage shadows of two of them, a Momentum slot, an
  int64 `global_step` and a variable partitioned in two (its slices start
  at 0 and 75: a two-byte key field);
- `tf2_sharded/`: a TF2 object-based checkpoint that
  `MaxShardSizePolicy` split into several data files (tensors sliced
  across them, the object graph a 0-d string);
- `saved_model/`: a TF2 SavedModel whose root lists two of its three
  variables as `variables` (the third is left out, as
  `tf.saved_model.load(...).variables` leaves it);
- `tf1_saved_model/`: a TF1 SavedModel (graph mode, written by
  `tf.compat.v1.saved_model.Builder` with its sharded saver): a resource
  variable with an ExponentialMovingAverage shadow, a ref variable (left
  out of `.variables`), a variable partitioned in two, `global_step` and a
  local variable that a Const initializes.

`check_fixtures` holds what the port reads against the twins (the CPU
tests and `chip_smoke.py` call it). A checkpoint's twin holds
`tensor/<key>`, what `tf.train.load_checkpoint` gives for each key, and
`arrays/<name>`, what the JAX package's
`load_tf_checkpoint_arrays` gives; the SavedModel's twin holds `arrays/
<name>` of the JAX package's `load_saved_model_arrays` (so does the TF1
one). `python -m tests.torch_port_tf_fixture CASE...` writes only those
cases again. The card has no
TensorFlow: there, these files show that the port reads what TensorFlow
writes.
"""

import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "data", "torch_port", "tf_bundles")
# each case's path under FIXTURES, as the readers are given it: the TF1
# case as its directory, the TF2 one (`Checkpoint.write` writes no
# `checkpoint` file) as its prefix
CASES = {"tf1": "tf1", "tf2_sharded": "tf2_sharded/ckpt",
         "saved_model": "saved_model", "tf1_saved_model": "tf1_saved_model"}
SAVED_MODELS = ("saved_model", "tf1_saved_model")


def tf1_values(seed: int = 0):
    """name -> value of the TF1 case's plain variables."""
    rng = np.random.default_rng(seed)
    return {
        "net/conv/kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
        "net/conv/bias": rng.normal(size=4).astype(np.float32),
        "net/bn/moving_mean": rng.normal(size=4).astype(np.float32),
        "net/wide": rng.normal(size=3),
        "net/count": rng.integers(-9, 9, 5).astype(np.int32),
        "net/half": rng.normal(size=6).astype(np.float16),
        "net/flag": rng.random(3) < 0.5,
        "net/q": rng.integers(-100, 100, 4).astype(np.int8),
        "net/u": rng.integers(0, 255, 4).astype(np.uint8),
        "net/s": rng.integers(-999, 999, 4).astype(np.int16),
    }


def write_tf1(directory: str, seed: int = 0, extra=None) -> str:
    """The TF1 case in `directory`, with the variables `extra` (name ->
    value) too; returns its prefix."""
    import tensorflow as tf

    tf1 = tf.compat.v1
    values = {**tf1_values(seed), **(extra or {})}
    graph = tf1.Graph()
    with graph.as_default():
        for name, val in values.items():
            tf1.get_variable(name, initializer=tf.constant(val))
        for name in ("net/conv/kernel", "net/conv/bias"):
            tf1.get_variable(f"{name}/ExponentialMovingAverage",
                             initializer=tf.constant(values[name] - 0.5))
        tf1.get_variable("net/conv/kernel/Momentum",
                         initializer=tf.constant(values["net/conv/kernel"]))
        tf1.get_variable("net/part", shape=(150, 2), dtype=tf.float32,
                         initializer=tf1.random_normal_initializer(seed=seed),
                         partitioner=tf1.fixed_size_partitioner(2))
        step = tf1.train.get_or_create_global_step()
        saver = tf1.train.Saver(save_relative_paths=True)
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            sess.run(step.assign(1234))
            return saver.save(sess, os.path.join(directory, "model.ckpt"),
                              global_step=step, write_meta_graph=False)


def write_tf2_sharded(directory: str, seed: int = 0,
                      shard_bytes: int = 2000) -> str:
    """The TF2 sharded case in `directory`; returns its prefix."""
    import tensorflow as tf

    rng = np.random.default_rng(seed)
    model = tf.Module()
    model.layers = [tf.Variable(rng.normal(size=(24, 16)).astype(
        np.float32), name=f"dense_{i}/kernel") for i in range(3)]
    model.bias = tf.Variable(rng.normal(size=16), name="bias")
    options = tf.train.CheckpointOptions(
        experimental_sharding_callback=tf.train.experimental
        .MaxShardSizePolicy(max_shard_size=shard_bytes))
    return tf.train.Checkpoint(model=model).write(
        os.path.join(directory, "ckpt"), options=options)


def write_saved_model(directory: str, seed: int = 0) -> str:
    """The SavedModel case at `directory`: `variables` lists net/b and
    net/a, the root also tracks `counter`."""
    import tensorflow as tf
    from tensorflow.python.trackable.autotrackable import AutoTrackable

    rng = np.random.default_rng(seed)
    root = AutoTrackable()
    root.a = tf.Variable(rng.normal(size=(2, 3)).astype(np.float32),
                         name="net/a")
    root.b = tf.Variable(rng.normal(size=4), name="net/b")
    root.counter = tf.Variable(5, dtype=tf.int64, name="counter")
    root.variables = [root.b, root.a]
    tf.saved_model.save(root, directory)
    return directory


def write_graph_mode_saved_model(directory: str, seed: int = 0) -> str:
    """The TF1 SavedModel case at `directory`."""
    import tensorflow as tf

    tf1 = tf.compat.v1
    rng = np.random.default_rng(seed)
    graph = tf1.Graph()
    with graph.as_default():
        w = tf1.get_variable("net/conv/kernel", initializer=tf.constant(
            rng.normal(size=(3, 3, 2, 4)).astype(np.float32)))
        tf1.get_variable("net/ref_bias", use_resource=False,
                         initializer=tf.constant(rng.normal(size=4).astype(
                             np.float32)))
        part = tf1.get_variable(
            "net/part", shape=(5, 2), dtype=tf.float32,
            partitioner=tf1.fixed_size_partitioner(2))
        step = tf1.train.get_or_create_global_step()
        ema = tf1.train.ExponentialMovingAverage(0.5)
        update = ema.apply([w])
        tf1.get_variable("metric/count", initializer=tf.constant(
            [3, -4, 5], tf.int32), collections=[tf1.GraphKeys.LOCAL_VARIABLES])
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            for p in part:
                sess.run(p.assign(rng.normal(size=p.shape).astype(
                    np.float32)))
            sess.run(update)
            sess.run(w.assign(w + 1.0))
            sess.run(step.assign(1234))
            builder = tf1.saved_model.Builder(directory)
            builder.add_meta_graph_and_variables(sess, ["serve"])
            builder.save()
    return directory


def tf_reader_tensors(path: str):
    """key -> what TensorFlow's checkpoint reader gives for it."""
    import tensorflow as tf

    reader = tf.train.load_checkpoint(path)
    return {k: reader.get_tensor(k)
            for k in reader.get_variable_to_shape_map()}


def port_read(path: str, case: str):
    """What the port reads of a case, under the twin's names (no
    TensorFlow: `models/tf_bundle`, `models/tf_import`)."""
    from human_body_proportion_estimation_tpu_torch.models import (
        tf_bundle,
        tf_import,
    )

    if case in SAVED_MODELS:
        arrays = tf_import.load_saved_model_arrays(path)
        return {f"arrays/{k}": v for k, v in arrays.items()}
    got = {f"tensor/{k}": v
           for k, v in tf_bundle.open_checkpoint(path).read().items()}
    arrays = tf_import.load_tf_checkpoint_arrays(path)
    return {**got, **{f"arrays/{k}": v for k, v in arrays.items()}}


def check_fixtures(directory: str = FIXTURES) -> dict:
    """Every case read by the port equals its twin bit for bit (the same
    names, dtypes, shapes and bytes); returns {case: values compared}."""
    counts = {}
    for case, where in CASES.items():
        got = port_read(os.path.join(directory, where), case)
        twin = np.load(os.path.join(directory, f"{case}.npz"))
        assert sorted(got) == sorted(twin.files), (case, sorted(got),
                                                   twin.files)
        for name, value in got.items():
            value, want = np.asarray(value), twin[name]
            assert (value.dtype, value.shape) == (want.dtype, want.shape), (
                case, name, value.dtype, want.dtype)
            assert value.tobytes() == want.tobytes(), (case, name)
        counts[case] = len(got)
    return counts


WRITERS = {"tf1": write_tf1, "tf2_sharded": write_tf2_sharded,
           "saved_model": write_saved_model,
           "tf1_saved_model": write_graph_mode_saved_model}


def generate(cases=tuple(CASES)):
    """Write `cases` (each directory and twin anew) with TensorFlow."""
    from human_body_proportion_estimation_tpu.models import tf_import as jtf

    os.makedirs(FIXTURES, exist_ok=True)
    for case in cases:
        where = CASES[case].split("/")[0]
        shutil.rmtree(os.path.join(FIXTURES, where), ignore_errors=True)
        WRITERS[case](os.path.join(FIXTURES, where))
        path = os.path.join(FIXTURES, CASES[case])
        twin = {}
        if case in SAVED_MODELS:
            arrays = jtf.load_saved_model_arrays(path)
        else:
            twin.update({f"tensor/{k}": np.asarray(v)
                         for k, v in tf_reader_tensors(path).items()})
            arrays = jtf.load_tf_checkpoint_arrays(path)
        twin.update({f"arrays/{k}": np.asarray(v) for k, v in arrays.items()})
        np.savez(os.path.join(FIXTURES, f"{case}.npz"), **twin)
        shutil.rmtree(os.path.join(FIXTURES, where, "assets"),
                      ignore_errors=True)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURES) for f in fs)
    print(f"wrote {', '.join(cases)} in {FIXTURES} ({size} bytes)")


if __name__ == "__main__":
    generate(tuple(sys.argv[1:]) or tuple(CASES))
