"""Articular-UNet trainer (models/unet.py params dict, optax adamw).

The shipped weights are trained by `train_mixture` on pipeline-extracted
polar images of exact-truth synthetic humeri (tools/make_unet_corpus.py)
plus sphere-labelled real fixtures (tools/export_polar_data.py), mixed
with `synth_polar_batch`: a procedural generative model of the same polar
image (spherical head offset from the canal axis, metaphysis/shaft,
bicipital groove notch, arthritic flattening, measurement noise),
synthesized directly in (z, theta) space on device as an infinite-variety
regularizer.  Label = pixel lies on the articular cap, the geometric
definition the sphere-consensus segmenter estimates (reference
bone_props.py:118-148).

Parallelism: dp over the batch axis via NamedSharding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax

from shoulder_tpu.models import unet


# ------------------------------------------------------------ data model
def synth_polar_batch(key, batch: int, size: int = 512):
    """Random (image, mask) pairs in polar space.

    Geometry: rays from the canal axis at height z hit either the head
    sphere (radius R, center offset c) or the shaft/metaphysis surface;
    the observed radius is the max of the two, the label is whether the
    head hit wins.
    """
    ks = jax.random.split(key, 13)
    f = lambda k, lo, hi: jax.random.uniform(k, (batch, 1, 1), minval=lo, maxval=hi)

    head_r = f(ks[0], 18.0, 28.0)
    off_x = f(ks[1], -8.0, 8.0)
    off_y = f(ks[2], 4.0, 14.0)          # posterior-ish offset
    head_cz = f(ks[3], -10.0, 2.0)       # head center below the image top
    shaft_r = f(ks[4], 9.0, 14.0)
    flare = f(ks[5], 0.0, 12.0)          # metaphyseal flare amplitude
    groove_th = f(ks[6], -jnp.pi, jnp.pi)
    groove_d = f(ks[7], 0.5, 4.0)
    groove_w = f(ks[8], 0.08, 0.3)
    flatten = f(ks[9], 0.0, 0.35)        # arthritic flattening factor

    # image rows: z from head top (row 0) downward ~55 mm
    z = jnp.linspace(0.0, -55.0, size)[None, :, None]        # (1, R, 1)
    th = jnp.linspace(-jnp.pi, jnp.pi, size, endpoint=False)[None, None, :]

    # ray from axis at height z, direction theta; head sphere hit radius
    dz = z - head_cz
    ux, uy = jnp.cos(th), jnp.sin(th)
    b = ux * off_x + uy * off_y
    c = off_x**2 + off_y**2 - (head_r**2 - dz**2)
    disc = b**2 - c
    hit = disc > 0
    r_head = jnp.where(hit, b + jnp.sqrt(jnp.maximum(disc, 0.0)), -jnp.inf)

    # articular CAP: the label is the sphere cut by the anatomic-neck
    # plane (the generator's exact-truth construction, io/testdata.py),
    # with the off-cap surface dropping into the neck recess crease
    incl = f(ks[12], jnp.deg2rad(30.0), jnp.deg2rad(62.0))
    az = jnp.arctan2(off_y, off_x)
    n_x = jnp.sin(incl) * jnp.cos(az)
    n_y = jnp.sin(incl) * jnp.sin(az)
    n_z = jnp.cos(incl)
    g = (
        (r_head * ux - off_x) * n_x
        + (r_head * uy - off_y) * n_y
        + dz * n_z
        - 0.10 * head_r
    )
    on_cap = hit & (g >= 0.0)
    r_art = jnp.where(
        on_cap, r_head, r_head - jnp.clip(1.1 * (-g), 0.0, 6.0)
    )
    # arthritic flattening of one flank of the cap
    dome = jnp.clip(g / (0.45 * head_r), 0.0, 1.0)
    r_art = r_art * (
        1.0 - flatten * dome * jnp.clip(jnp.cos(th - az - 0.7), 0, 1) ** 2
    )

    # shaft + flare grows toward the bottom of the window
    depth = jnp.clip((-z - 25.0) / 30.0, 0.0, 1.0)
    r_shaft = shaft_r + flare * depth**2

    image_r = jnp.maximum(jnp.where(hit, r_art, -jnp.inf), r_shaft)
    label = (on_cap & (r_art > r_shaft)).astype(jnp.float32)

    # bicipital groove notch (cut into whichever surface is outermost)
    dth = jnp.arctan2(jnp.sin(th - groove_th), jnp.cos(th - groove_th))
    notch = groove_d * jnp.exp(-0.5 * (dth / groove_w) ** 2)
    image_r = image_r - notch

    # noise + per-image min-max normalization (matches pipeline input,
    # anatomic_neck.py:56-58)
    key_n = ks[10]
    image_r = image_r + 0.15 * jax.random.normal(key_n, image_r.shape)
    lo = jnp.min(image_r, axis=(1, 2), keepdims=True)
    hi = jnp.max(image_r, axis=(1, 2), keepdims=True)
    image = (image_r - lo) / (hi - lo)

    # random roll in theta (the pipeline anchors at the groove; train for
    # robustness to anchor error)
    shift = jax.random.randint(ks[11], (batch,), 0, size)
    image = jax.vmap(lambda im, s: jnp.roll(im, s, axis=-1))(image, shift)
    label = jax.vmap(lambda im, s: jnp.roll(im, s, axis=-1))(label, shift)
    return image[..., None], label[..., None]


# ---------------------------------------------------------------- train
def bce_loss(params, images, labels):
    logits = unet.apply(params, images)
    loss = optax.sigmoid_binary_cross_entropy(logits, labels)
    return jnp.mean(loss)


def _boundary_weight(labels, amp: float = 4.0, halo: int = 5):
    """Per-pixel weight emphasising a halo around the mask boundary.

    The metrics downstream (neck-shaft, retroversion) are driven entirely
    by where the mask EDGE lands (the plane is fit to edge pixels,
    landmarks._anatomic_neck), so boundary pixels carry most of the loss.
    """
    y = labels[..., 0]
    ez = jnp.abs(jnp.diff(y, axis=1, prepend=y[:, :1]))
    et = jnp.abs(jnp.diff(y, axis=2, prepend=y[:, :, :1]))
    e = jnp.maximum(ez, et)[..., None]
    e = jax.lax.reduce_window(e, -jnp.inf, jax.lax.max, (1, halo, halo, 1),
                              (1, 1, 1, 1), "SAME")
    return 1.0 + amp * e


def dice_bce_loss(params, images, labels, boundary_amp: float = 4.0):
    """Boundary-weighted BCE + soft dice (region-overlap) loss."""
    logits = unet.apply(params, images)
    w = _boundary_weight(labels, boundary_amp)
    bce = optax.sigmoid_binary_cross_entropy(logits, labels)
    bce = jnp.sum(w * bce) / jnp.sum(w)
    p = jax.nn.sigmoid(logits)
    inter = jnp.sum(p * labels, axis=(1, 2, 3))
    denom = jnp.sum(p, axis=(1, 2, 3)) + jnp.sum(labels, axis=(1, 2, 3))
    dice = 1.0 - jnp.mean((2.0 * inter + 1.0) / (denom + 1.0))
    return bce + dice


def train(
    steps: int = 500,
    batch: int = 8,
    size: int = 512,
    lr: float = 3e-4,
    seed: int = 0,
    mesh=None,
    log_every: int = 50,
):
    key = jax.random.PRNGKey(seed)
    key, init_key = jax.random.split(key)
    params = unet.init_params(init_key)
    tx = optax.adamw(lr)
    opt_state = tx.init(params)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        data_sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
        repl = NamedSharding(mesh, P())
        params = jax.device_put(params, repl)
        opt_state = jax.device_put(opt_state, repl)
    else:
        data_sharding = None

    @jax.jit
    def step(params, opt_state, images, labels):
        loss, grads = jax.value_and_grad(bce_loss)(params, images, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    gen = jax.jit(functools.partial(synth_polar_batch, batch=batch,
                                    size=size))
    losses = []
    for i in range(steps):
        key, dk = jax.random.split(key)
        images, labels = gen(dk)
        if data_sharding is not None:
            images = jax.device_put(images, data_sharding)
            labels = jax.device_put(labels, data_sharding)
        params, opt_state, loss = step(params, opt_state, images, labels)
        if i % log_every == 0:
            losses.append(float(loss))
            print(f"[unet] step {i} loss {float(loss):.4f}", flush=True)
    return params, losses


def dryrun(mesh, batch: int = 8, image_size: int = 64) -> None:
    """One dp-sharded training step on tiny shapes (multi-chip dryrun)."""
    params = unet.init_params(jax.random.PRNGKey(0), features=(4, 8))
    tx = optax.adamw(1e-3)
    opt_state = tx.init(params)

    from jax.sharding import NamedSharding, PartitionSpec as P

    repl = NamedSharding(mesh, P())
    data_sh = NamedSharding(mesh, P(mesh.axis_names[0]))
    params = jax.device_put(params, repl)
    opt_state = jax.device_put(opt_state, repl)
    images, labels = synth_polar_batch(jax.random.PRNGKey(1), batch,
                                       image_size)
    images = jax.device_put(images, data_sh)
    labels = jax.device_put(labels, data_sh)

    @jax.jit
    def step(params, opt_state, images, labels):
        loss, grads = jax.value_and_grad(bce_loss)(params, images, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    params, opt_state, loss = step(params, opt_state, images, labels)
    jax.block_until_ready(loss)


def train_mixture(
    corpus_images,
    corpus_masks,
    steps: int = 3000,
    batch: int = 16,
    size: int = 512,
    lr: float = 3e-4,
    seed: int = 0,
    frac_procedural: float = 0.25,
    boundary_amp: float = 4.0,
    log_every: int = 100,
    init_params=None,
):
    """Train on a mixture of pipeline-extracted corpus pairs and the
    procedural polar generator.

    The corpus (tools/make_unet_corpus.py + real-fixture pairs) carries the
    pipeline's true image distribution — groove-anchored roll, real
    normalization, surgical-neck windowing — which the round-1
    procedural-only training lacked (the 15-degree neck-shaft gap was a
    domain-gap symptom).  The procedural stream stays in the mix as an
    infinite-variety regularizer.  Corpus samples are augmented with random
    theta rolls (the image axis is periodic) and mild noise.

    The whole corpus is uploaded once and sampled ON DEVICE inside the
    jitted step (fp16 at rest; a 512^2 float corpus is ~0.5 MB/pair), so
    no step waits on a host-to-device batch.
    """
    key = jax.random.PRNGKey(seed)
    key, init_key = jax.random.split(key)
    params = init_params
    if params is None:
        params = unet.init_params(init_key)
    tx = optax.adamw(lr)
    opt_state = tx.init(params)

    corpus_images = jax.device_put(jnp.asarray(corpus_images, jnp.float16))
    corpus_masks = jax.device_put(jnp.asarray(corpus_masks, jnp.float16))
    n_total = corpus_images.shape[0]
    n_proc = max(1, int(round(batch * frac_procedural)))
    n_corp = batch - n_proc

    # corpus arrays ride as ARGUMENTS, not closure captures: a captured
    # jnp array is embedded in the HLO as a constant (a 288-pair fp16
    # corpus is ~150 MB of program)
    @jax.jit
    def step(params, opt_state, key, corpus_images, corpus_masks):
        kidx, kroll, knoise, kproc = jax.random.split(key, 4)
        idx = jax.random.randint(kidx, (n_corp,), 0, n_total)
        ci = corpus_images[idx].astype(jnp.float32)
        cm = corpus_masks[idx].astype(jnp.float32)
        shift = jax.random.randint(kroll, (n_corp,), 0, size)
        roll = lambda a, s: jnp.roll(a, s, axis=-1)
        ci = jax.vmap(roll)(ci, shift)
        cm = jax.vmap(roll)(cm, shift)
        ci = ci + 0.01 * jax.random.normal(knoise, ci.shape)
        images, labels = ci[..., None], cm[..., None]
        if n_proc:
            pi, pm = synth_polar_batch(kproc, n_proc, size)
            images = jnp.concatenate([images, pi])
            labels = jnp.concatenate([labels, pm])
        loss, grads = jax.value_and_grad(dice_bce_loss)(
            params, images, labels, boundary_amp
        )
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    losses = []
    for i in range(steps):
        key, sk = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, sk,
                                       corpus_images, corpus_masks)
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss))
            print(f"[unet] step {i} loss {float(loss):.4f}", flush=True)
    return params, losses
