"""KIE metrics: Donut-style field F1 and normalized tree edit distance.

Parity target: CC-OCR KieEvaluator
(reference Benchmarks/CC-OCR/evaluation/evaluator/kie_evaluator.py:
normalize_dict :88, flatten semantics, cal_f1_all :122 [micro field F1 =
tp / (tp + (fn+fp)/2)], construct_tree_from_dict :190, cal_acc :226
[nTED accuracy = max(0, 1 - TED/TED(empty, gt))];
also OmniParser KIE eval protocol).

The port's copy of `advancedliteratemachinery_tpu/eval/kie_metrics.py`, on
the port's `eval/tree_edit.py`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

from advancedliteratemachinery_tpu_torch.eval.tree_edit import Node, tree_edit_distance


def normalize_dict(data: Any) -> Any:
    """Sort keys, drop empties, coerce scalars to [str] (kie_evaluator.py:88)."""
    if not data:
        return {}
    if isinstance(data, dict):
        new: Dict[str, Any] = {}
        for key in sorted(data.keys(), key=lambda k: (len(str(k)), str(k))):
            value = normalize_dict(data[key])
            if value:
                if not isinstance(value, list):
                    value = [value]
                new[key] = value
        return new
    if isinstance(data, list):
        if all(isinstance(item, dict) for item in data):
            return [v for v in (normalize_dict(i) for i in data) if v]
        return [str(i).strip() for i in data
                if type(i) in {str, int, float} and str(i).strip()]
    return [str(data).strip()]


def flatten(data: Any, prefix: str = "") -> List[Tuple[str, str]]:
    """dict tree → list of (field_name, value) pairs."""
    out: List[Tuple[str, str]] = []
    if isinstance(data, dict):
        for k, v in data.items():
            out.extend(flatten(v, k))
    elif isinstance(data, list):
        for item in data:
            if isinstance(item, (dict, list)):
                out.extend(flatten(item, prefix))
            else:
                out.append((prefix, str(item)))
    else:
        out.append((prefix, str(data)))
    return out


def field_f1(preds: Dict[str, Any], answers: Dict[str, Any]) -> float:
    """Micro field-level F1 over samples (cal_f1_all :122)."""
    total_tp, total_fn_or_fp = 0, 0
    for file_name, answer in answers.items():
        pred = preds.get(file_name, {})
        p = flatten(normalize_dict(pred))
        a = flatten(normalize_dict(answer))
        a = list(a)
        for field in p:
            if field in a:
                total_tp += 1
                a.remove(field)
            else:
                total_fn_or_fp += 1
        total_fn_or_fp += len(a)
    return total_tp / (total_tp + total_fn_or_fp / 2 + 1e-6)


def dict_to_tree(data: Union[Dict, List, str], label: str = "root") -> Node:
    """construct_tree_from_dict (kie_evaluator.py:190)."""
    node = Node(label)
    if isinstance(data, dict):
        for k, v in data.items():
            node.children.append(dict_to_tree(v, str(k)))
    elif isinstance(data, list):
        for item in data:
            if isinstance(item, (dict, list)):
                node.children.append(dict_to_tree(item, "<item>"))
            else:
                node.children.append(Node(str(item)))
    else:
        node.children.append(Node(str(data)))
    return node


def ntED(pred: Dict[str, Any], answer: Dict[str, Any]) -> float:
    """Donut nTED accuracy: max(0, 1 - TED(pred,gt) / TED(empty,gt))
    (cal_acc :226)."""
    gt_tree = dict_to_tree(normalize_dict(answer))
    pred_tree = dict_to_tree(normalize_dict(pred))
    empty = Node("root")
    denom = tree_edit_distance(empty, gt_tree)
    if denom == 0:
        return 1.0 if tree_edit_distance(pred_tree, gt_tree) == 0 else 0.0
    return max(0.0, 1.0 - tree_edit_distance(pred_tree, gt_tree) / denom)


def vie_entities_to_dict(entities: List[Dict[str, Any]]) -> Dict[str, List[str]]:
    """OmniParser VIE entities (eval.spotting_eval.decode_vie_outputs
    output: {"text", "class", ...}) → a Donut-style {class: [texts]} dict
    for field_f1 / ntED. Repeated classes accumulate in reading order,
    matching the reference's per-class-token result rows
    (transformer.py:205-210)."""
    out: Dict[str, List[str]] = {}
    for e in entities:
        out.setdefault(e["class"], []).append(e["text"])
    return out


def evaluate_vie(pred_entities: Dict[str, List[Dict[str, Any]]],
                 answers: Dict[str, Dict[str, Any]]) -> Dict[str, float]:
    """Dataset-level VIE scoring: micro field F1 + mean nTED accuracy over
    images (the reference reports CORD/SROIE "F1" and "Acc" — F1 from
    field matching, Acc the Donut tree accuracy)."""
    preds = {k: vie_entities_to_dict(v) for k, v in pred_entities.items()}
    f1 = field_f1(preds, answers)
    accs = [ntED(preds.get(k, {}), v) for k, v in answers.items()]
    acc = sum(accs) / len(accs) if accs else 0.0
    return {"field_f1": f1, "ntED_acc": acc}


# ---------------- BIO entity-level SER scoring ----------------


def bio_entities(seq: List[str]) -> List[Tuple[str, int, int]]:
    """BIO tag sequence → (type, start, end) entity spans, with seqeval's
    default (lenient) chunking — the scorer GeoLayoutLM's SER evaluation
    uses (reference lightning_modules/geolayoutlm_vie_module.py:478-480,
    seqeval f1_score over parse_str_from_seq outputs): a chunk starts at
    B-x, or at I-x when not continuing a chunk of the same type; it ends
    before O, before any B-, or on a type change."""
    ents: List[Tuple[str, int, int]] = []
    start = -1
    prev_tag, prev_type = "O", ""
    for i, chunk in enumerate(list(seq) + ["O"]):
        tag = chunk[0]
        typ = chunk[2:] if len(chunk) > 2 else ""
        end_of = prev_tag in "BI" and (tag in "OB" or typ != prev_type)
        start_of = tag == "B" or (tag == "I" and
                                  (prev_tag == "O" or typ != prev_type))
        if end_of and start >= 0:
            ents.append((prev_type, start, i - 1))
            start = -1
        if start_of:
            start = i
        prev_tag, prev_type = tag, typ
    return ents


def bio_entity_f1(gt_seqs: List[List[str]], pr_seqs: List[List[str]]
                  ) -> Dict[str, float]:
    """Entity-level micro precision/recall/F1 over BIO sequences
    (seqeval semantics — exact (type, span) matches)."""
    tp = n_gt = n_pr = 0
    for gt, pr in zip(gt_seqs, pr_seqs):
        g = set(bio_entities(gt))
        p = set(bio_entities(pr))
        tp += len(g & p)
        n_gt += len(g)
        n_pr += len(p)
    prec = tp / n_pr if n_pr else 0.0
    rec = tp / n_gt if n_gt else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"precision": prec, "recall": rec, "f1": f1}
