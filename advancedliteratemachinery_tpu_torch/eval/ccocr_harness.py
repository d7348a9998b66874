"""CC-OCR benchmark harness: metric protocol, registry, summary.

Behavioral parity target (reference Benchmarks/CC-OCR/evaluation):
- BaseMetric protocol (evaluator/common.py:69): `response_post_func`,
  `evaluate` returning {"summary": {...}}, and `__call__` (:91) taking a
  response dict or a directory of per-image responses, tracking
  post-processing failures and adding response_success_ratio.
- main.py:11 evaluate_and_summary: index-driven evaluation over subsets,
  per-dataset status.json and a cross-dataset summary (:121 — mean or
  sample-weighted overall).

Evaluators plug in the framework's metric implementations
(eval/ocr_metrics.py, eval/kie_metrics.py, eval/teds.py).

The port's copy of `advancedliteratemachinery_tpu/eval/ccocr_harness.py`,
on the port's metrics. `collect_predictions` calls `model_fn` from
`workers` threads at once; the port's pipelines may be called so on one
card (their kernels' loads and launch counts take a lock, and each call
keeps its tensors to itself), and give what one thread gives."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

from advancedliteratemachinery_tpu_torch.eval.kie_metrics import field_f1, ntED
from advancedliteratemachinery_tpu_torch.eval.ocr_metrics import token_metrics
from advancedliteratemachinery_tpu_torch.eval.teds import TEDS, extract_and_clean_tables


def load_response_from_dir(path: str) -> Dict[str, str]:
    """Directory of per-image response files → {stem: text}
    (common.py:40-66)."""
    out = {}
    for name in os.listdir(path):
        full = os.path.join(path, name)
        if not os.path.isfile(full):
            continue
        stem, ext = os.path.splitext(name)
        with open(full, encoding="utf-8", errors="ignore") as f:
            text = f.read()
        if ext == ".json":
            try:
                d = json.loads(text)
                # dashscope/openai-style response unwrapping
                for k in ("response", "text", "content", "answer"):
                    if isinstance(d, dict) and k in d:
                        text = d[k] if isinstance(d[k], str) else json.dumps(d[k])
                        break
            except json.JSONDecodeError:
                pass
        out[stem] = text
    return out


class BaseMetric:
    def __init__(self, group_name: str, **kwargs):
        self.group_name = group_name
        self.kwargs = kwargs

    def response_post_func(self, response_text, **kwargs):
        return response_text

    def evaluate(self, response_info, gt_info, **kwargs) -> Dict[str, Any]:
        raise NotImplementedError

    def __call__(self, pdt_res, gt_info, with_response_ratio: bool = True,
                 **kwargs) -> Tuple[Dict, Dict]:
        if isinstance(pdt_res, dict):
            raw = pdt_res
        elif os.path.isdir(str(pdt_res)):
            raw = load_response_from_dir(pdt_res)
        else:
            raise ValueError(f"invalid input: dict or dir required, got {pdt_res}")

        post_errors, responses = [], {}
        missing = list(gt_info.keys() - raw.keys())
        for name, text in raw.items():
            post = self.response_post_func(text, **kwargs)
            if post is None:
                post_errors.append(name)
                continue
            responses[name] = post

        meta = {"gt_total_num": len(gt_info), "pdt_total_num": len(responses),
                "post_error_list": post_errors, "response_error_list": missing}
        result = self.evaluate(responses, gt_info, **kwargs)
        if "summary" in result and with_response_ratio:
            ratio = (len(responses) + len(post_errors)) / (len(gt_info) + 1e-9)
            result["summary"]["response_success_ratio"] = ratio
        return meta, result


class OcrEvaluator(BaseMetric):
    """Token-level macro/micro metrics (evaluator/ocr_evaluator.py:78)."""

    def evaluate(self, response_info, gt_info, **kwargs):
        dataset = kwargs.get("dataset", "")
        word_level = not (dataset in ("Arabic", "Japanese", "Korean")
                          or "zh" in dataset)
        alphanum = "multi_scene_ocr" in self.group_name and word_level
        m = token_metrics(response_info, gt_info, word_level=word_level,
                          lowercase=True, alphanum_only=alphanum)
        return {"summary": {"macro_f1_score": m["macro_f1_score"],
                            "mirco_f1_score": m["micro_f1_score"]},
                "metric_config": {"word_level": word_level,
                                  "alphanum_only": alphanum}}


class KieEvaluator(BaseMetric):
    """Field F1 + nTED (evaluator/kie_evaluator.py:361)."""

    def response_post_func(self, response_text, **kwargs):
        if isinstance(response_text, dict):
            return response_text
        text = str(response_text)
        # strip markdown fences (post_process_to_json :310)
        if "```" in text:
            parts = text.split("```")
            text = parts[1] if len(parts) > 1 else text
            if text.startswith("json"):
                text = text[4:]
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            return None

    def evaluate(self, response_info, gt_info, **kwargs):
        gts = {k: (json.loads(v) if isinstance(v, str) else v)
               for k, v in gt_info.items()}
        f1 = field_f1(response_info, gts)
        nted = sum(ntED(response_info.get(k, {}), v) for k, v in gts.items()
                   ) / max(len(gts), 1)
        return {"summary": {"f1_score": f1, "nted_acc": nted}}


class ParsingEvaluator(BaseMetric):
    """Table TEDS / S-TEDS (evaluator/doc_parsing_evaluator.py:186)."""

    def evaluate(self, response_info, gt_info, **kwargs):
        teds = TEDS()
        steds = TEDS(structure_only=True)
        t_sum = s_sum = 0.0
        for k, gt in gt_info.items():
            pred = extract_and_clean_tables(str(response_info.get(k, "")))
            gtc = extract_and_clean_tables(str(gt)) or str(gt)
            t_sum += teds.evaluate(pred, gtc)
            s_sum += steds.evaluate(pred, gtc)
        n = max(len(gt_info), 1)
        return {"summary": {"teds": t_sum / n, "s_teds": s_sum / n}}


EVALUATOR_MAP: Dict[str, Callable] = {
    "multi_scene_ocr": OcrEvaluator,
    "multi_lan_ocr": OcrEvaluator,
    "doc_parsing": ParsingEvaluator,
    "kie": KieEvaluator,
}


def evaluate_and_summary(index: list, responses_by_dataset: Dict[str, Dict],
                         gts_by_dataset: Dict[str, Dict],
                         weighted: bool = False) -> Dict[str, Any]:
    """Index-driven harness (main.py:11) over in-memory responses/gts.
    index: [{"dataset", "group", ...}]. Returns per-dataset evaluation +
    overall summary (mean of each dataset's first summary metric, or
    sample-weighted when `weighted`)."""
    all_info: Dict[str, Any] = {}
    scores, weights = [], []
    for item in index:
        name = item["dataset"]
        group = item["group"]
        if not item.get("release", True) or name not in responses_by_dataset:
            continue
        ev_cls = EVALUATOR_MAP.get(group)
        if ev_cls is None:
            raise ValueError(f"evaluator not defined for group: {group}")
        meta, result = ev_cls(group)(responses_by_dataset[name],
                                     gts_by_dataset[name], dataset=name)
        all_info[name] = {"config": item, "meta": meta, "evaluation": result,
                          "time": time.strftime("%Y-%m-%d %H:%M:%S")}
        summary = result.get("summary", {})
        main_metric = next((v for k, v in summary.items()
                            if k != "response_success_ratio"), None)
        if main_metric is not None:
            scores.append(float(main_metric))
            weights.append(meta["gt_total_num"])
    if scores:
        if weighted:
            total_w = sum(weights)
            overall = sum(s * w for s, w in zip(scores, weights)) / total_w
        else:
            overall = sum(scores) / len(scores)
        all_info["_overall"] = {"score": overall, "datasets": len(scores),
                                "weighted": weighted}
    return all_info


# ---------------- prediction collection (reference example.py) ----------------


def collect_predictions(
    index: list,
    base_dir: str,
    output_dir: str,
    model_fn: Callable[[str, str], str],
    model_name: str = "local",
    workers: int = 4,
    resume: bool = True,
) -> Dict[str, Dict[str, int]]:
    """Run a model over a CC-OCR-format benchmark tree and write the
    per-image response directories the evaluator harness consumes.

    Parity target: Benchmarks/CC-OCR/example.py — per released dataset in
    the index, read `<base_dir>/<dataset base_dir>/qa.jsonl` lines
    ({"url", "prompt"}), call the model on (image_path, question), and
    write `<output_dir>/<model_name>/<dataset>/<image name>.json` with
    {image, question, model_name, response, time}; existing outputs are
    skipped when `resume` (example.py `is_resume`). Failures are logged
    and skipped (the reference prints and returns None), so a partial
    pass can be re-run to fill gaps.

    `model_fn(image_path, question) -> response text` is injected: the
    reference's dashscope/OpenAI callers are network clients (zero-egress
    here); local equivalents are the framework's own pipelines, or any
    callable importable as `module:attr` (cli `ccocr-collect`).
    Returns per-dataset {"total": N, "ok": n_written, "skipped": n_resume}.
    """
    from concurrent.futures import ThreadPoolExecutor
    from urllib.parse import unquote, urlparse

    stats: Dict[str, Dict[str, int]] = {}
    for item in index:
        if not item.get("release", True):
            continue
        name = item["dataset"]
        data_dir = os.path.join(base_dir, item.get("base_dir", name))
        qa_path = os.path.join(data_dir, "qa.jsonl")
        if not os.path.exists(qa_path):
            stats[name] = {"total": 0, "ok": 0, "skipped": 0,
                           "missing_qa": 1}
            continue
        out_dir = os.path.join(output_dir, model_name, name)
        os.makedirs(out_dir, exist_ok=True)

        todo, skipped = [], 0
        with open(qa_path, encoding="utf-8") as f:
            for line in f:
                rec = json.loads(line)
                url, question = rec["url"], rec["prompt"]
                fname = os.path.basename(unquote(urlparse(url).path)) + ".json"
                out_path = os.path.join(out_dir, fname)
                if resume and os.path.exists(out_path):
                    skipped += 1
                    continue
                todo.append((os.path.join(data_dir, url), question, out_path))

        def run_one(task):
            image_path, question, out_path = task
            try:
                response = model_fn(image_path, question)
            except Exception as e:   # noqa: BLE001 — example.py skips failures
                print(f"--> error: skip {image_path}: {e}")
                return 0
            with open(out_path, "w", encoding="utf-8") as f:
                json.dump({"image": image_path, "question": question,
                           "model_name": model_name, "response": response,
                           "time": time.time()},
                          f, indent=2, ensure_ascii=False)
            return 1

        if workers > 1 and len(todo) > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                ok = sum(ex.map(run_one, todo))
        else:
            ok = sum(run_one(t) for t in todo)
        stats[name] = {"total": len(todo) + skipped, "ok": ok,
                       "skipped": skipped}
    return stats
