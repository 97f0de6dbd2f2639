"""Graph-mode tf.data parse functions (TensorFlow optional).

A copy of the JAX package's ``records/parsers_tf.py``: drop-in
graph-mode equivalents of the numpy parsers in ``records/parsers.py``
for an existing ``tf.data`` flow (``ds.map(parse_fn, 8)``; the
reference's _tfrecord_image_translation.py:269-316, 389-415). Their
outputs equal the numpy parsers'. ``parse_encoded_gdal_proto_wrapped_tf``
decodes through the port's own codecs inside ``tf.numpy_function``.

TensorFlow is imported on first call: importing this module without it
is fine. The port's own feed and the card's path never import it.
"""

from __future__ import annotations


def _tf():
    import tensorflow as tf
    return tf


def parse_encoded_rgb_img_proto_tf(example_proto):
    """Graph-mode C4: encoded PNG/JPG image + label bytes -> decoded
    uint8 tensors (reference :269-293). Returns (img, target,
    identifier)."""
    tf = _tf()
    from .parsers import featuretemplate_bytestring_imagechip
    f = tf.io.parse_single_example(example_proto,
                                   featuretemplate_bytestring_imagechip)
    img = tf.io.decode_image(f["image/image_data"],
                             expand_animations=False)
    target = tf.io.decode_image(f["target/target_data"],
                                expand_animations=False)
    return img, target, f["identifier"]


def parse_8bit_array_proto_tf(example_proto):
    """Graph-mode C5: raw uint8 array bytes -> reshaped tensors with
    the reference's size checks (reference :296-316). Image is
    (h, w, c); target is (h, w)."""
    tf = _tf()
    from .parsers import featuretemplate_bytestring_imagechip
    f = tf.io.parse_single_example(example_proto,
                                   featuretemplate_bytestring_imagechip)
    ih = tf.cast(f["image/height"], tf.int32)
    iw = tf.cast(f["image/width"], tf.int32)
    ic = tf.cast(f["image/channels"], tf.int32)
    th = tf.cast(f["target/height"], tf.int32)
    tw = tf.cast(f["target/width"], tf.int32)
    img_1d = tf.io.decode_raw(f["image/image_data"], tf.uint8)
    tf.debugging.assert_equal(
        tf.size(img_1d), ih * iw * ic,
        message="Decoded image size does not match recorded dims")
    img = tf.reshape(img_1d, tf.stack([ih, iw, ic]))
    tgt_1d = tf.io.decode_raw(f["target/target_data"], tf.uint8)
    tf.debugging.assert_equal(
        tf.size(tgt_1d), th * tw,
        message="Decoded target size does not match recorded dims")
    target = tf.reshape(tgt_1d, tf.stack([th, tw]))
    return img, target, f["identifier"]


def parse_higher_dtype_array_proto_tf(example_proto):
    """Graph-mode C8: FloatList arrays -> reshaped float32 tensors
    (reference :389-415). Image is (h, w, c); target is (h, w)."""
    tf = _tf()
    from .parsers import featuretemplate_ndarray_imagechip
    f = tf.io.parse_single_example(example_proto,
                                   featuretemplate_ndarray_imagechip)
    ih = tf.cast(f["image/height"], tf.int32)
    iw = tf.cast(f["image/width"], tf.int32)
    ic = tf.cast(f["image/channels"], tf.int32)
    th = tf.cast(f["target/height"], tf.int32)
    tw = tf.cast(f["target/width"], tf.int32)
    img = tf.reshape(f["image/image_data"], tf.stack([ih, iw, ic]))
    target = tf.reshape(f["target/target_data"], tf.stack([th, tw]))
    return img, target, f["identifier"]


def parse_encoded_gdal_proto_wrapped_tf(example_proto):
    """Graph-mode C6: encoded any-format raster bytes decoded through
    this framework's codecs inside tf.numpy_function, fixed float32
    output (reference :319-346)."""
    tf = _tf()
    from .parsers import _decode_f32, featuretemplate_bytestring_imagechip

    f = tf.io.parse_single_example(example_proto,
                                   featuretemplate_bytestring_imagechip)

    def _decode(b):
        # the numpy parser's decode; eagerly the string arrives as a 0-d
        # object array (the JAX package's bytes(b) reads its pointer)
        return _decode_f32(b.item() if hasattr(b, "item") else bytes(b))

    img = tf.numpy_function(_decode, [f["image/image_data"]], tf.float32)
    target = tf.numpy_function(_decode, [f["target/target_data"]],
                               tf.float32)
    return img, target, f["identifier"]
