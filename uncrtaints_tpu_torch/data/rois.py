"""ROI tables and official train/val/test splits.

The port's own copy of uncrtaints_tpu/data/rois.py (the tests hold the two
equal). These are data, mirrored verbatim from the reference's
data/dataLoader.py (:149-190 for SEN12MS-CR-TS, :554-593 for SEN12MS-CR), so
split membership is the same. Paths use '/' joining on all platforms.
"""

ROI_TS = {
    "ROIs1158": ["106"],
    "ROIs1868": ["17", "36", "56", "73", "85", "100", "114", "119", "121",
                 "126", "127", "139", "142", "143"],
    "ROIs1970": ["20", "21", "35", "40", "57", "65", "71", "82", "83", "91",
                 "112", "116", "119", "128", "132", "133", "135", "139",
                 "142", "144", "149"],
    "ROIs2017": ["8", "22", "25", "32", "49", "61", "63", "69", "75", "103",
                 "108", "115", "116", "117", "130", "140", "146"],
}

_J = "/".join


def splits_ts(region: str):
    """Region-filtered train/val/test split tables (dataLoader.py:156-190)."""
    s = {}
    if region == "all":
        all_roi = [_J([k, v]) for k, vals in ROI_TS.items() for v in vals]
        s["test"] = ["ROIs1868/119", "ROIs1970/139", "ROIs2017/108",
                     "ROIs2017/63", "ROIs1158/106", "ROIs1868/73",
                     "ROIs2017/32", "ROIs1868/100", "ROIs1970/132",
                     "ROIs2017/103", "ROIs1868/142", "ROIs1970/20",
                     "ROIs2017/140"]
        s["val"] = ["ROIs2017/22", "ROIs1970/65", "ROIs2017/117",
                    "ROIs1868/127", "ROIs1868/17"]
        s["train"] = [r for r in all_roi
                      if r not in s["val"] and r not in s["test"]]
    elif region == "africa":
        s["test"] = ["ROIs2017/32", "ROIs2017/140"]
        s["val"] = ["ROIs2017/22"]
        s["train"] = ["ROIs1970/21", "ROIs1970/35", "ROIs1970/40",
                      "ROIs2017/8", "ROIs2017/61", "ROIs2017/75"]
    elif region == "america":
        s["test"] = ["ROIs1158/106", "ROIs1970/132"]
        s["val"] = ["ROIs1970/65"]
        s["train"] = ["ROIs1868/36", "ROIs1868/85", "ROIs1970/82",
                      "ROIs1970/142", "ROIs2017/49", "ROIs2017/116"]
    elif region == "asiaEast":
        s["test"] = ["ROIs1868/73", "ROIs1868/119", "ROIs1970/139"]
        s["val"] = ["ROIs2017/117"]
        s["train"] = ["ROIs1868/114", "ROIs1868/126", "ROIs1868/143",
                      "ROIs1970/116", "ROIs1970/135", "ROIs2017/25"]
    elif region == "asiaWest":
        s["test"] = ["ROIs1868/100"]
        s["val"] = ["ROIs1868/127"]
        s["train"] = ["ROIs1970/57", "ROIs1970/83", "ROIs1970/112",
                      "ROIs2017/69", "ROIs2017/115", "ROIs2017/130"]
    elif region == "europa":
        s["test"] = ["ROIs2017/63", "ROIs2017/103", "ROIs2017/108",
                     "ROIs1868/142", "ROIs1970/20"]
        s["val"] = ["ROIs1868/17"]
        s["train"] = ["ROIs1868/56", "ROIs1868/121", "ROIs1868/139",
                      "ROIs1970/71", "ROIs1970/91", "ROIs1970/119",
                      "ROIs1970/128", "ROIs1970/133", "ROIs1970/144",
                      "ROIs1970/149", "ROIs2017/146"]
    else:
        raise NotImplementedError(region)
    s["all"] = s["train"] + s["test"] + s["val"]
    return s


def splits_cr():
    """SEN12MS-CR mono-temporal ROI-string splits (dataLoader.py:560-593).
    Matching is by substring against full patch paths."""
    s = {}
    s["train"] = [
        "ROIs1970_fall_s1/s1_3", "ROIs1970_fall_s1/s1_22",
        "ROIs1970_fall_s1/s1_148", "ROIs1970_fall_s1/s1_107",
        "ROIs1970_fall_s1/s1_1", "ROIs1970_fall_s1/s1_114",
        "ROIs1970_fall_s1/s1_135", "ROIs1970_fall_s1/s1_40",
        "ROIs1970_fall_s1/s1_42", "ROIs1970_fall_s1/s1_31",
        "ROIs1970_fall_s1/s1_149", "ROIs1970_fall_s1/s1_64",
        "ROIs1970_fall_s1/s1_28", "ROIs1970_fall_s1/s1_144",
        "ROIs1970_fall_s1/s1_57", "ROIs1970_fall_s1/s1_35",
        "ROIs1970_fall_s1/s1_133", "ROIs1970_fall_s1/s1_30",
        "ROIs1970_fall_s1/s1_134", "ROIs1970_fall_s1/s1_141",
        "ROIs1970_fall_s1/s1_112", "ROIs1970_fall_s1/s1_116",
        "ROIs1970_fall_s1/s1_37", "ROIs1970_fall_s1/s1_26",
        "ROIs1970_fall_s1/s1_77", "ROIs1970_fall_s1/s1_100",
        "ROIs1970_fall_s1/s1_83", "ROIs1970_fall_s1/s1_71",
        "ROIs1970_fall_s1/s1_93", "ROIs1970_fall_s1/s1_119",
        "ROIs1970_fall_s1/s1_104", "ROIs1970_fall_s1/s1_136",
        "ROIs1970_fall_s1/s1_6", "ROIs1970_fall_s1/s1_41",
        "ROIs1970_fall_s1/s1_125", "ROIs1970_fall_s1/s1_91",
        "ROIs1970_fall_s1/s1_131", "ROIs1970_fall_s1/s1_120",
        "ROIs1970_fall_s1/s1_110", "ROIs1970_fall_s1/s1_19",
        "ROIs1970_fall_s1/s1_14", "ROIs1970_fall_s1/s1_81",
        "ROIs1970_fall_s1/s1_39", "ROIs1970_fall_s1/s1_109",
        "ROIs1970_fall_s1/s1_33", "ROIs1970_fall_s1/s1_88",
        "ROIs1970_fall_s1/s1_11", "ROIs1970_fall_s1/s1_128",
        "ROIs1970_fall_s1/s1_142", "ROIs1970_fall_s1/s1_122",
        "ROIs1970_fall_s1/s1_4", "ROIs1970_fall_s1/s1_27",
        "ROIs1970_fall_s1/s1_147", "ROIs1970_fall_s1/s1_85",
        "ROIs1970_fall_s1/s1_82", "ROIs1970_fall_s1/s1_105",
        "ROIs1158_spring_s1/s1_9", "ROIs1158_spring_s1/s1_1",
        "ROIs1158_spring_s1/s1_124", "ROIs1158_spring_s1/s1_40",
        "ROIs1158_spring_s1/s1_101", "ROIs1158_spring_s1/s1_21",
        "ROIs1158_spring_s1/s1_134", "ROIs1158_spring_s1/s1_145",
        "ROIs1158_spring_s1/s1_141", "ROIs1158_spring_s1/s1_66",
        "ROIs1158_spring_s1/s1_8", "ROIs1158_spring_s1/s1_26",
        "ROIs1158_spring_s1/s1_77", "ROIs1158_spring_s1/s1_113",
        "ROIs1158_spring_s1/s1_100", "ROIs1158_spring_s1/s1_117",
        "ROIs1158_spring_s1/s1_119", "ROIs1158_spring_s1/s1_6",
        "ROIs1158_spring_s1/s1_58", "ROIs1158_spring_s1/s1_120",
        "ROIs1158_spring_s1/s1_110", "ROIs1158_spring_s1/s1_126",
        "ROIs1158_spring_s1/s1_115", "ROIs1158_spring_s1/s1_121",
        "ROIs1158_spring_s1/s1_39", "ROIs1158_spring_s1/s1_109",
        "ROIs1158_spring_s1/s1_63", "ROIs1158_spring_s1/s1_75",
        "ROIs1158_spring_s1/s1_132", "ROIs1158_spring_s1/s1_128",
        "ROIs1158_spring_s1/s1_142", "ROIs1158_spring_s1/s1_15",
        "ROIs1158_spring_s1/s1_45", "ROIs1158_spring_s1/s1_97",
        "ROIs1158_spring_s1/s1_147", "ROIs1868_summer_s1/s1_90",
        "ROIs1868_summer_s1/s1_87", "ROIs1868_summer_s1/s1_25",
        "ROIs1868_summer_s1/s1_124", "ROIs1868_summer_s1/s1_114",
        "ROIs1868_summer_s1/s1_135", "ROIs1868_summer_s1/s1_40",
        "ROIs1868_summer_s1/s1_101", "ROIs1868_summer_s1/s1_42",
        "ROIs1868_summer_s1/s1_31", "ROIs1868_summer_s1/s1_36",
        "ROIs1868_summer_s1/s1_139", "ROIs1868_summer_s1/s1_56",
        "ROIs1868_summer_s1/s1_133", "ROIs1868_summer_s1/s1_55",
        "ROIs1868_summer_s1/s1_43", "ROIs1868_summer_s1/s1_113",
        "ROIs1868_summer_s1/s1_76", "ROIs1868_summer_s1/s1_123",
        "ROIs1868_summer_s1/s1_143", "ROIs1868_summer_s1/s1_93",
        "ROIs1868_summer_s1/s1_125", "ROIs1868_summer_s1/s1_89",
        "ROIs1868_summer_s1/s1_120", "ROIs1868_summer_s1/s1_126",
        "ROIs1868_summer_s1/s1_72", "ROIs1868_summer_s1/s1_115",
        "ROIs1868_summer_s1/s1_121", "ROIs1868_summer_s1/s1_146",
        "ROIs1868_summer_s1/s1_140", "ROIs1868_summer_s1/s1_95",
        "ROIs1868_summer_s1/s1_102", "ROIs1868_summer_s1/s1_7",
        "ROIs1868_summer_s1/s1_11", "ROIs1868_summer_s1/s1_132",
        "ROIs1868_summer_s1/s1_15", "ROIs1868_summer_s1/s1_137",
        "ROIs1868_summer_s1/s1_4", "ROIs1868_summer_s1/s1_27",
        "ROIs1868_summer_s1/s1_147", "ROIs1868_summer_s1/s1_86",
        "ROIs1868_summer_s1/s1_47", "ROIs2017_winter_s1/s1_68",
        "ROIs2017_winter_s1/s1_25", "ROIs2017_winter_s1/s1_62",
        "ROIs2017_winter_s1/s1_135", "ROIs2017_winter_s1/s1_42",
        "ROIs2017_winter_s1/s1_64", "ROIs2017_winter_s1/s1_21",
        "ROIs2017_winter_s1/s1_55", "ROIs2017_winter_s1/s1_112",
        "ROIs2017_winter_s1/s1_116", "ROIs2017_winter_s1/s1_8",
        "ROIs2017_winter_s1/s1_59", "ROIs2017_winter_s1/s1_49",
        "ROIs2017_winter_s1/s1_104", "ROIs2017_winter_s1/s1_81",
        "ROIs2017_winter_s1/s1_146", "ROIs2017_winter_s1/s1_75",
        "ROIs2017_winter_s1/s1_94", "ROIs2017_winter_s1/s1_102",
        "ROIs2017_winter_s1/s1_61", "ROIs2017_winter_s1/s1_47",
        # also used for testing in SEN12MS-CR-TS (dataLoader.py:588 note)
        "ROIs1868_summer_s1/s1_100",
    ]
    s["val"] = [
        "ROIs2017_winter_s1/s1_22", "ROIs1868_summer_s1/s1_19",
        "ROIs1970_fall_s1/s1_65", "ROIs1158_spring_s1/s1_17",
        "ROIs2017_winter_s1/s1_107", "ROIs1868_summer_s1/s1_80",
        "ROIs1868_summer_s1/s1_127", "ROIs2017_winter_s1/s1_130",
        "ROIs1868_summer_s1/s1_17", "ROIs2017_winter_s1/s1_84",
    ]
    s["test"] = [
        "ROIs1158_spring_s1/s1_106", "ROIs1158_spring_s1/s1_123",
        "ROIs1158_spring_s1/s1_140", "ROIs1158_spring_s1/s1_31",
        "ROIs1158_spring_s1/s1_44", "ROIs1868_summer_s1/s1_119",
        "ROIs1868_summer_s1/s1_73", "ROIs1970_fall_s1/s1_139",
        "ROIs2017_winter_s1/s1_108", "ROIs2017_winter_s1/s1_63",
    ]
    s["all"] = s["train"] + s["test"] + s["val"]
    return s
