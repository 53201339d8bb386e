"""The layers over the misc and image groups in the port against the JAX
package's, on the CPU, at a tiny size.

* every layer builds the same ``to_dict()`` as the JAX package's, main and
  startup, under the same ``unique_name.guard()`` (int32 read as int64,
  source paths dropped), parameters and initializers included
  (``data_norm``'s three statistics, ``spectral_norm``'s U and V,
  ``center_loss``'s centres);
* from the JAX package's initial scope (``interop.scope_from_numpy``)
  every layer's output agrees (f32 rtol 1e-5, atol 1e-5; ints exactly);
* four composite programs train 3 steps with SGD to the JAX package's
  losses (rtol 1e-5): C3D-like (conv3d, pool3d, conv3d_transpose, the
  trilinear resizes, adaptive_pool3d, fc, cross_entropy2), TSM- and
  STN-like (temporal_shift, conv2d, lrn, shuffle_channel, pixel_shuffle,
  space_to_depth, affine_grid, grid_sampler, affine_channel, unfold),
  Transformer-like (add_position_encoding, row_conv,
  bilinear_tensor_product, label_smooth, spectral_norm) and CTR-like
  (data_norm, continuous_value_model, teacher_student_sigmoid_loss,
  center_loss, hash, unique_with_counts);
* the reference's deviations the port keeps: ``center_loss``'s centres
  never move, ``data_norm``'s statistics never move, ``spectral_norm``'s
  U and V are never written; ``filter_by_instag`` is refused.
"""
import numpy as np
import pytest

from test_torch_lod import PKGS, build_both, carried_scopes, normalized, \
    run_steps
from test_torch_sequence_ops import f32, ints

RTOL, ATOL = 1e-5, 1e-5
LOSS_RTOL = 1e-5


def video(fl):
    L = fl.layers
    clip = L.data("clip", shape=[3, 4, 8, 8], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    c = L.conv3d(clip, num_filters=4, filter_size=3, padding=1, act="relu")
    p = L.pool3d(c, pool_size=[1, 2, 2], pool_type="max",
                 pool_stride=[1, 2, 2])
    t = L.conv3d_transpose(p, num_filters=3, filter_size=2, stride=2)
    r = L.resize_trilinear(t, out_shape=[4, 6, 6], align_corners=False)
    r2 = L.resize_trilinear(p, scale=2)
    a = L.adaptive_pool3d(r2, [2, 2, 2], pool_type="avg")
    g = L.pool3d(r, pool_type="avg", global_pooling=True)
    feat = L.concat([L.reshape(a, [-1, 32]), L.reshape(g, [-1, 3])],
                    axis=1)
    prob = L.softmax(L.fc(feat, 5))
    loss = L.mean(L.cross_entropy2(prob, label))
    fl.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return {"outs": [c, p, t, r, r2, a, prob], "loss": loss}


def video_feed(seed):
    return {"clip": f32(2, 3, 4, 8, 8, seed=seed),
            "label": ints(5, 2, 1, seed=seed + 1)}


def tsm_stn(fl):
    L = fl.layers
    # the shift reshapes the batch by seg_num: a static batch of 2 clips
    frames = L.data("frames", shape=[6, 8, 6, 6], dtype="float32",
                    append_batch_size=False)
    scale = L.data("scale", shape=[8], dtype="float32",
                   append_batch_size=False)
    bias = L.data("bias", shape=[8], dtype="float32",
                  append_batch_size=False)
    s = L.temporal_shift(frames, seg_num=3, shift_ratio=0.25)
    c = L.conv2d(s, num_filters=8, filter_size=3, padding=1, act="relu")
    n = L.lrn(c, n=5, k=2.0, alpha=1e-2)
    sh = L.shuffle_channel(n, group=2)
    ps = L.pixel_shuffle(sh, 2)
    sd = L.space_to_depth(ps, 2)
    theta = L.reshape(L.fc(sd, 6), [-1, 2, 3])
    grid = L.affine_grid(theta, out_shape=[1, 8, 5, 5])
    g = L.grid_sampler(sd, grid)
    ac = L.affine_channel(g, scale=scale, bias=bias)
    u = L.unfold(ac, kernel_sizes=2)
    loss = L.mean(L.square(u))
    fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return {"outs": [s, n, sh, ps, sd, grid, g, ac, u], "loss": loss}


def tsm_feed(seed):
    return {"frames": f32(6, 8, 6, 6, seed=seed),
            "scale": f32(8, seed=seed + 1),
            "bias": f32(8, seed=seed + 2)}


def transformer(fl):
    L = fl.layers
    x = L.data("x", shape=[6, 8], dtype="float32")
    label = L.data("label", shape=[1], dtype="int64")
    pe = L.add_position_encoding(x, alpha=0.5, beta=1.0)
    rc = L.row_conv(pe, future_context_size=2, act="tanh")
    a = L.reduce_mean(rc, dim=1)
    b = L.reduce_max(pe, dim=1)
    bt = L.bilinear_tensor_product(a, b, size=4, act="tanh")
    h = L.fc(bt, 4, param_attr=fl.ParamAttr(name="sn_w"))
    sn = L.spectral_norm(fl.default_main_program().global_block.var("sn_w"),
                         dim=1, power_iters=2)
    prob = L.softmax(L.elementwise_add(L.matmul(bt, sn), h))
    smooth = L.label_smooth(L.one_hot(label, 4), epsilon=0.1)
    loss = L.mean(L.cross_entropy(prob, smooth, soft_label=True))
    fl.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return {"outs": [pe, rc, bt, sn, prob, smooth], "loss": loss}


def transformer_feed(seed):
    return {"x": f32(3, 6, 8, seed=seed), "label": ints(4, 3, 1, seed=seed)}


def ctr(fl):
    L = fl.layers
    dense = L.data("dense", shape=[6], dtype="float32")
    show_click = L.data("show_click", shape=[2], dtype="float32")
    teacher = L.data("teacher", shape=[1], dtype="float32")
    cls = L.data("cls", shape=[1], dtype="int64")
    ids = L.data("ids", shape=[3], dtype="int64")
    dn = L.data_norm(dense)
    cv = L.continuous_value_model(L.concat([show_click, dn], axis=1),
                                  show_click, use_cvm=True)
    h = L.fc(cv, 4, act="relu")
    logit = L.fc(h, 1)
    tsl = L.teacher_student_sigmoid_loss(logit, teacher)
    cl = L.center_loss(h, cls, num_classes=3, alpha=0.5)
    hashed = L.hash(ids, hash_size=97, num_hash=1)
    uniq, index, count = L.unique_with_counts(L.reshape(ids, [-1]))
    loss = L.elementwise_add(L.mean(tsl), L.mean(cl))
    fl.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return {"outs": [dn, cv, tsl, cl, hashed, uniq, index, count],
            "loss": loss}


def ctr_feed(seed):
    rng = np.random.RandomState(seed)
    return {"dense": f32(5, 6, seed=seed),
            "show_click": rng.randint(0, 20, (5, 2)).astype(np.float32),
            "teacher": np.array([[-2], [-1], [0.3], [1.5], [0.9]],
                                np.float32),
            "cls": ints(3, 5, 1, seed=seed + 1),
            "ids": ints(6, 5, 3, seed=seed + 2, lo=-3)}


def tensors(fl):
    """The layers with no parameter (values only)."""
    L = fl.layers
    img = L.data("img", shape=[3, 6, 7], dtype="float32")
    big = L.data("big", shape=[3, 8, 9], dtype="float32")
    w = L.data("w", shape=[4, 3, 3], dtype="float32",
               append_batch_size=False)
    idx = L.data("idx", shape=[1], dtype="int32")
    ids = L.data("ids", shape=[4], dtype="int64")
    outs = [
        L.strided_slice(img, axes=[1, 2], starts=[0, 6], ends=[6, 0],
                        strides=[2, -3]),
        L.crop(img, shape=[2, 2, 3, 4], offsets=[0, 1, 1, 2]),
        L.crop_tensor(img, shape=[2, 3, 5, 5], offsets=[0, 0, 1, 2]),
        L.pad_constant_like(big, img, pad_value=0.5),
        L.im2sequence(img, filter_size=[2, 3], stride=[2, 1], padding=1),
        L.fsp_matrix(img, L.scale(img, scale=2.0)),
        L.image_resize_short(img, 4),
        L.similarity_focus(L.floor(img), axis=1, indexes=[0, 2]),
        L.spectral_norm(w, dim=0, power_iters=3),
        L.multiplex([L.reshape(img, [-1, 126]),
                     L.reshape(L.scale(img, scale=-1.0), [-1, 126])], idx),
        *L.unique(L.reshape(ids, [-1]), dtype="int64"),
        L.hash(ids, hash_size=1000, num_hash=1),
    ]
    return {"outs": outs}


def tensors_feed(seed):
    return {"img": f32(2, 3, 6, 7, seed=seed, scale=2.0),
            "big": f32(2, 3, 8, 9, seed=seed + 1),
            "w": f32(4, 3, 3, seed=seed + 2),
            "idx": np.array([[1], [0]], np.int32),
            "ids": ints(5, 2, 4, seed=seed + 3)}


NETS = {"video": (video, video_feed), "tsm_stn": (tsm_stn, tsm_feed),
        "transformer": (transformer, transformer_feed),
        "ctr": (ctr, ctr_feed), "tensors": (tensors, tensors_feed)}
TRAINED = ("video", "tsm_stn", "transformer", "ctr")


@pytest.fixture(scope="module")
def built():
    return {name: build_both(fn) for name, (fn, _) in NETS.items()}


@pytest.mark.parametrize("name", sorted(NETS))
def test_layers_build_the_jax_programs(built, name):
    b = built[name]
    for k in (0, 1):
        assert normalized(b["torch"][k]) == normalized(b["jax"][k])


def _assert_values(names, tout, jout):
    for n, a, b in zip(names, tout, jout):
        b = np.asarray(b)
        assert a.shape == b.shape, (n, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), err_msg=n)


@pytest.mark.parametrize("name", sorted(NETS))
def test_layers_compute_the_jax_values(built, name):
    b = built[name]
    feed = NETS[name][1](11)
    outs = b["torch"][2]["outs"]
    fetch = [v.name for v in outs]
    assert fetch == [v.name for v in b["jax"][2]["outs"]]
    scopes, _ = carried_scopes(b)
    res = {}
    for pkg in PKGS:
        exe, scope = scopes[pkg]
        main = b[pkg][0]
        if name in TRAINED:
            main = main.clone(for_test=True)
        res[pkg] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    _assert_values(fetch, res["torch"], res["jax"])


@pytest.mark.parametrize("name", TRAINED)
def test_composite_trains_three_steps_as_jax(built, name):
    b = built[name]
    feeds = [NETS[name][1](20 + s) for s in range(3)]
    loss = b["torch"][2]["loss"].name
    res = run_steps(b, feeds, [loss])
    for step in range(3):
        np.testing.assert_allclose(res["torch"][step][0],
                                   res["jax"][step][0], rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    assert res["torch"][2][0] != res["torch"][0][0]


def test_centers_and_statistics_never_move_as_in_jax(built):
    """Two SGD steps of the CTR program: the centres parameter and
    data_norm's three statistics keep their initial values in both
    packages (CentersOut is a temporary; the statistics take no
    gradient), and each step's loss and CentersOut agree."""
    b = built["ctr"]
    scopes, state = carried_scopes(b)
    tmain = b["torch"][0]
    op = next(o for o in tmain.global_block.ops if o.type == "center_loss")
    centers, c_out = op.inputs["Centers"][0], op.outputs["CentersOut"][0]
    dn = next(o for o in tmain.global_block.ops if o.type == "data_norm")
    stats = [dn.inputs[s][0] for s in ("BatchSize", "BatchSum",
                                       "BatchSquareSum")]
    fetch = [b["torch"][2]["loss"].name, c_out]
    for step in range(2):
        feed = ctr_feed(40 + step)
        got = {pkg: scopes[pkg][0].run(b[pkg][0], feed=feed,
                                       fetch_list=fetch,
                                       scope=scopes[pkg][1])
               for pkg in PKGS}
        for a, j in zip(got["torch"], got["jax"]):
            np.testing.assert_allclose(a, j, rtol=RTOL, atol=ATOL)
        assert np.abs(got["torch"][1] - state[centers]).max() > 0
        for pkg in PKGS:
            scope = scopes[pkg][1]
            for n in [centers] + stats:
                np.testing.assert_array_equal(
                    np.asarray(scope.numpy(n)), state[n], err_msg=(pkg, n))


def test_spectral_norm_leaves_u_and_v_as_the_startup_set_them(built):
    b = built["transformer"]
    scopes, state = carried_scopes(b)
    op = next(o for o in b["torch"][0].global_block.ops
              if o.type == "spectral_norm")
    uv = [op.inputs["U"][0], op.inputs["V"][0]]
    exe, scope = scopes["torch"]
    for s in range(2):
        exe.run(b["torch"][0], feed=transformer_feed(30 + s),
                fetch_list=[b["torch"][2]["loss"].name], scope=scope)
    for n in uv:
        np.testing.assert_array_equal(np.asarray(scope.numpy(n)), state[n])


def test_random_layers_build_the_jax_programs_and_run():
    def net(fl):
        L = fl.layers
        x = L.data("x", shape=[3, 8, 9], dtype="float32")
        p = L.data("p", shape=[5], dtype="float32")
        return [L.random_crop(x, shape=[3, 5, 6], seed=3),
                L.sampling_id(p, seed=2)]

    b = build_both(net)
    for k in (0, 1):
        assert normalized(b["torch"][k]) == normalized(b["jax"][k])
    fl = PKGS["torch"][0]
    x = f32(2, 3, 8, 9, seed=5)
    p = np.full((4, 5), 0.2, np.float32)
    crop, ids = fl.Executor(fl.CPUPlace()).run(
        b["torch"][0], feed={"x": x, "p": p},
        fetch_list=[v.name for v in b["torch"][2]], scope=fl.Scope())
    assert crop.shape == (2, 3, 5, 6) and ids.shape == (4,)
    assert any(np.array_equal(x[:, :, i:i + 5, j:j + 6], crop)
               for i in range(4) for j in range(4))
    assert ids.min() >= 0 and ids.max() < 5


def test_filter_by_instag_is_refused_as_in_jax():
    msgs = []
    for fl, _ in PKGS.values():
        with pytest.raises(NotImplementedError) as e:
            fl.layers.filter_by_instag(None, None, None)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
