"""Run-directory, logging and argument-dump helpers (port of
`vae_gp_ode_tpu/utils/io.py`): the training CLIs write their run
directories through these."""

import json
import logging
import os


def makedirs(path):
    os.makedirs(path, exist_ok=True)
    return path


def get_logger(logpath=None, name='vae_gp_ode_tpu_torch', displaying=True,
               saving=True, debug=False):
    """The logger `name` with its handlers replaced: a file handler on
    `logpath` (when `saving` and given) and a stream handler (when
    `displaying`), '%(asctime)s %(message)s', not propagating."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG if debug else logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter('%(asctime)s %(message)s')
    if saving and logpath is not None:
        fh = logging.FileHandler(logpath)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if displaying:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    logger.propagate = False
    return logger


def save_args(args, path):
    """Dump the run configuration as JSON: the arguments whose values are
    int, float, str, bool, None or list, sorted by name."""
    d = {k: v for k, v in sorted(vars(args).items())
         if isinstance(v, (int, float, str, bool, type(None), list))}
    with open(path, 'w') as f:
        json.dump(d, f, indent=2)
