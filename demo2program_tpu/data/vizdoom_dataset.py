"""ViZDoom dataset reader.

Parity target: `vizdoom_env/dataset_vizdoom.py` — like the Karel loader plus:
  * perception history stored as p_v_h / test_p_v_h (`:110-122`)
  * per-position-key initial actor positions `vizdoom_init_pos[_len]` and the
    test variants, padded to vizdoom_max_init_pos_len (`:124-138`) — needed
    to re-initialize engine episodes for execution-accuracy scoring
  * extra data_info: vizdoom_pos_keys, vizdoom_max_init_pos_len,
    perception_type, level, s_h_h/w/c (`dataset_vizdoom.py:33-46`)

num_k slicing happens at the raw-read stage (`:62, 73, 107, 113, 125`).
"""

import numpy as np

from demo2program_tpu.data.dataset import KarelDataset, _scalar, all_ids
from demo2program_tpu.data.store import data_file, open_store
from demo2program_tpu.utils import log


class VizdoomDataset(KarelDataset):
    def __init__(self, ids, dataset_path, name="default", num_k=10,
                 is_train=True):
        self._ids = list(ids)
        self.name = name
        self.num_k = num_k
        self.is_train = is_train
        self.dataset_path = dataset_path

        filename = data_file(dataset_path)
        log.info("Reading %s ...", filename)
        self.data = open_store(filename)
        info = self.data["data_info"]
        self.num_demo = int(_scalar(info["num_demo_per_program"]))
        self.max_demo_len = int(_scalar(info["max_demo_length"]))
        self.max_program_len = int(_scalar(info["max_program_length"]))
        self.num_program_tokens = int(_scalar(info["num_program_tokens"]))
        self.num_action_tokens = int(_scalar(info["num_action_tokens"]))
        self.vizdoom_pos_keys = [
            k.decode() if isinstance(k, bytes) else str(k)
            for k in info["vizdoom_pos_keys"][()]]
        self.vizdoom_max_init_pos_len = int(
            _scalar(info["vizdoom_max_init_pos_len"]))
        self.perception_type = _scalar(info["perception_type"])
        self.sprite_style = (_scalar(info["sprite_style"])
                             if "sprite_style" in info else "v2")
        self.level = (_scalar(info["level"]) if "level" in info
                      else "not_simple")
        self.dsl_type = "vizdoom_default"
        self.env_type = "vizdoom_default"
        self.k = self.num_demo
        self.test_k = int(_scalar(info["num_test_demo_per_program"]))
        self.s_h_h = int(_scalar(info["s_h_h"]))
        self.s_h_w = int(_scalar(info["s_h_w"]))
        self.s_h_c = int(_scalar(info["s_h_c"]))
        self._store = self._maybe_preload(filename)

    def get_data_compact(self, id_):
        raise NotImplementedError(
            "ViZDoom demos are engine-rendered video, not reconstructible "
            "from initial state + actions; use the full wire format")

    def get_batch_compact(self, id_list):
        self.get_data_compact(None)

    def get_data(self, id_):
        grp = self._store[id_]
        k = self.num_k
        program_tokens = grp["program"][()]
        program = np.zeros(
            [self.num_program_tokens, self.max_program_len], dtype=bool)
        program[program_tokens, np.arange(len(program_tokens))] = True
        padded_program_tokens = np.zeros(
            [self.max_program_len], dtype=program_tokens.dtype)
        padded_program_tokens[:len(program_tokens)] = program_tokens

        def pad_demo(arr):
            sz = arr.shape
            out = np.zeros([sz[0], self.max_demo_len] + list(sz[2:]),
                           dtype=arr.dtype)
            out[:, :sz[1]] = arr
            return out

        demo = pad_demo(grp["s_h"][()][:k])
        test_demo = pad_demo(grp["test_s_h"][()])
        per = pad_demo(grp["p_v_h"][()][:k])
        test_per = pad_demo(grp["test_p_v_h"][()])

        a_h, a_h_tokens = self._action_onehots(grp["a_h"][()][:k])
        test_a_h, test_a_h_tokens = self._action_onehots(
            grp["test_a_h"][()])

        def pad_init_pos(arr):
            sz = arr.shape
            out = np.zeros([sz[0], sz[1], self.vizdoom_max_init_pos_len, 2],
                           dtype=arr.dtype)
            out[:, :, :sz[2], :] = arr
            return out

        init_pos = pad_init_pos(grp["vizdoom_init_pos"][()][:k])
        init_pos_len = grp["vizdoom_init_pos_len"][()][:k]
        test_init_pos = pad_init_pos(grp["test_vizdoom_init_pos"][()])
        test_init_pos_len = grp["test_vizdoom_init_pos_len"][()]

        return {
            "id": id_,
            "program": program.astype(np.uint8),
            "program_tokens": padded_program_tokens.astype(np.int32),
            # raw 0..255 pixel values, exactly as the reference feeds them
            # (`input_ops_vizdoom.py` casts to float32 without scaling);
            # shipped as uint8, cast to float on device
            "s_h": demo.astype(np.uint8),
            "test_s_h": test_demo.astype(np.uint8),
            "a_h": a_h.astype(np.uint8),
            "a_h_tokens": a_h_tokens.astype(np.int32),
            "test_a_h": test_a_h.astype(np.uint8),
            "test_a_h_tokens": test_a_h_tokens.astype(np.int32),
            "program_len": np.array([len(program_tokens)], np.float32),
            "demo_len": grp["s_h_len"][()][:k].astype(np.float32),
            "test_demo_len": grp["test_s_h_len"][()].astype(np.float32),
            "per": per.astype(np.uint8),
            "test_per": test_per.astype(np.uint8),
            "init_pos": init_pos.astype(np.int32),
            "init_pos_len": init_pos_len.astype(np.int32),
            "test_init_pos": test_init_pos.astype(np.int32),
            "test_init_pos_len": test_init_pos_len.astype(np.int32),
        }


def create_vizdoom_splits(dataset_path, num_k=10, is_train=True):
    ids_train, ids_test, ids_val = all_ids(dataset_path)
    return (VizdoomDataset(ids_train, dataset_path, "train", num_k, is_train),
            VizdoomDataset(ids_test, dataset_path, "test", num_k, is_train),
            VizdoomDataset(ids_val, dataset_path, "val", num_k, is_train))
